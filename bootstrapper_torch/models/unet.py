"""Residual valid-convolution U-Net as ``nn.Module``s.

The plain graph of the JAX package's ``models/unet.py:unet_apply`` (the
path it takes with no folded levels), in the same channels-last layout:
activations are ``(N, D, H, W, C)`` and conv weights are DHWIO, so the
JAX params carry over unchanged (``models/weights.py``).

A 2D net runs as a 3D net with a unit z axis (``lift_2d_config``, the
JAX package's ``_lift_2d_config``): kernels ``(k1, k2)`` become
``(1, k1, k2)``, factors ``(a, b)`` become ``(1, a, b)``, so its input is
``(N, 1, H, W, C)`` and its conv weights carry a unit z axis.  The convs
are the same; the trilinear upsample with a z factor of 1 equals the 2D
linear resize.

- ConvPass: valid convs with activations between, plus a 1x1 projection
  of the input, centre-cropped and added, then the final activation.
- The decoder's skip concat is implicit: each conv over ``[skip, up]`` is
  a sum of per-part convs with channel-split weights (``conv_split``).
- Max-pool down; trilinear upsample with ``align_corners=False`` (equal
  to ``jax.image.resize`` linear); ``crop_to_factor`` keeps the valid
  convs translation-equivariant at the upsample stride.
- ReLU between convs; one decoder (``num_heads`` 1), as every shipped
  setup has.

Every conv goes through ``ops.conv3d.conv3d``, which routes it by shape to
the hand-written Hopper kernel or to ``torch.nn.functional.conv3d``; with
grad enabled the kernel route is ``ops.conv3d.Conv3dFunction``, so the net
trains with fp32 parameters and convs in the model's ``compute_dtype``.
Under ``BS_INT8=1`` with grad disabled every conv, of every shape, goes
through ``ops.quant.qconv`` instead, each part of a channel concat
quantized on its own and a residual's input scaled before its crop, as
the JAX package's graph quantizes them.  The
TPU fold, lazy-decode and z-slab machinery of the JAX package is layout
work that computes nothing new and is not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import quant
from ..ops.conv3d import conv3d, pack_weights, to_channels_last


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int
    num_fmaps: int
    fmap_inc_factor: int
    downsample_factors: tuple  # ((z,y,x), ...)
    kernel_size_down: tuple  # per level: (kernel, ...)
    kernel_size_up: tuple  # per level below top: (kernel, ...)
    num_fmaps_out: Optional[int] = None

    def __post_init__(self):
        object.__setattr__(
            self,
            "downsample_factors",
            tuple(tuple(f) for f in self.downsample_factors),
        )
        object.__setattr__(
            self,
            "kernel_size_down",
            tuple(tuple(tuple(k) for k in lvl) for lvl in self.kernel_size_down),
        )
        object.__setattr__(
            self,
            "kernel_size_up",
            tuple(tuple(tuple(k) for k in lvl) for lvl in self.kernel_size_up),
        )

    @property
    def num_levels(self) -> int:
        return len(self.downsample_factors) + 1

    @property
    def dims(self) -> int:
        return len(self.kernel_size_down[0][0])

    @property
    def out_channels(self) -> int:
        return self.num_fmaps_out or self.num_fmaps

    @property
    def crop_factors(self) -> tuple:
        """Cumulative downsample products, bottom-up, per decoder level."""
        factors = []
        product = None
        for f in self.downsample_factors[::-1]:
            product = list(f) if product is None else [a * b for a, b in zip(f, product)]
            factors.append(tuple(product))
        return tuple(factors[::-1])


def lift_2d_config(cfg: UNetConfig) -> UNetConfig:
    """A 2D config as the 3D config of the same net with a unit z axis."""
    return dataclasses.replace(
        cfg,
        downsample_factors=tuple((1, *f) for f in cfg.downsample_factors),
        kernel_size_down=tuple(tuple((1, *k) for k in lvl) for lvl in cfg.kernel_size_down),
        kernel_size_up=tuple(tuple((1, *k) for k in lvl) for lvl in cfg.kernel_size_up),
    )


# in place, on tensors this module has just made: a conv output keeps the
# layout ``ops.conv3d.empty_channels_last`` gave it.  Autograd allows it:
# no backward saves what these update (a conv saves its output only where
# ReLU is fused into it, and that output is never updated), and the
# kernel route's outputs are no views (``ops.conv3d.Conv3dFunction``)
_ACTIVATIONS = {"relu": torch.relu_, "sigmoid": torch.sigmoid_}


def center_crop(x, target_spatial: Sequence[int]):
    """Centre-crop the spatial dims (all but first/last axes) of x: a view."""
    spatial = x.shape[1 : 1 + len(target_spatial)]
    offsets = [(s - t) // 2 for s, t in zip(spatial, target_spatial)]
    sl = tuple(slice(o, o + t) for o, t in zip(offsets, target_spatial))
    return x[(slice(None),) + sl]


class Conv(nn.Module):
    """One conv's parameters: ``w`` (kd, kh, kw, Ci, Co), ``b`` (Co), in
    the JAX layout; the conv kernel's packed form of ``w`` is kept beside
    it (``packed``) and is no part of the state dict."""

    def __init__(self, kernel: Sequence[int], in_ch: int, out_ch: int):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(*kernel, in_ch, out_ch))
        self.b = nn.Parameter(torch.zeros(out_ch))
        self._packed = {}
        self._packed_of = None

    def packed(self, dtype, lo: int = 0, hi: Optional[int] = None):
        """``pack_weights`` of the input-channel slice ``[lo, hi)`` of
        ``w`` for ``dtype``, made once per (parameter version, storage,
        dtype, device, slice): an in-place update of ``w``
        (``load_state_dict``, an optimizer step) or a move (``.to``) drops
        what was packed.  An update must bump ``w._version``: fused Adam
        does not, so the port's trainer does not use it
        (``train/loop.py:create_train_state``).  ``dtype`` ``torch.int8``
        gives ``quant.pack_qweights`` of the slice: its int8 weights, scales
        and kernel layout."""
        w = self.w
        of = self._packed_of  # (the tensor packed from, its version then)
        if (
            of is None
            or of[1] != w._version
            or of[0].data_ptr() != w.data_ptr()
            or of[0].dtype != w.dtype
            or of[0].device != w.device
        ):
            # holding the tensor keeps its storage, so that no later
            # parameter can come to lie at the same address unnoticed
            self._packed, self._packed_of = {}, (w.detach(), w._version)
        key = (dtype, lo, hi)
        if key not in self._packed:
            part = w.detach()[..., lo:hi, :]
            self._packed[key] = quant.pack_qweights(part) if dtype == torch.int8 else pack_weights(part, dtype)
        return self._packed[key]


def conv_split(xs, conv: Conv, relu: bool = False, scale_of=None):
    """Conv over the implicit channel concat of ``xs``: the sum of per-part
    convs with channel-split weights (the bias enters with the first).
    Under int8 (``quant.int8_active``) each part is quantized on its own, as
    the JAX package's ``_conv_split`` does, with its scale taken over the
    matching tensor of ``scale_of`` where given (a residual's uncropped
    inputs)."""
    q8 = quant.int8_active()
    off = 0
    y = None
    for i, x in enumerate(xs):
        c = x.shape[-1]
        w = conv.w if len(xs) == 1 else conv.w[..., off : off + c, :]
        b = conv.b if y is None else None
        if q8:
            part = quant.qconv(
                x, w, b, relu=relu and len(xs) == 1, qw=conv.packed(torch.int8, off, off + c),
                scale_of=None if scale_of is None else scale_of[i],
            )
        else:
            part = conv3d(
                x, w, b, relu=relu and len(xs) == 1,
                pack=lambda x=x, lo=off, hi=off + c: conv.packed(x.dtype, lo, hi),
            )
        # in place: the first part's output keeps its 16-byte voxel lines
        y = part if y is None else y.add_(part)
        off += c
    return torch.relu_(y) if relu and len(xs) > 1 else y


class ConvPass(nn.Module):
    def __init__(self, in_ch, out_ch, kernel_sizes, activation="relu"):
        super().__init__()
        layers = []
        ch = in_ch
        for k in kernel_sizes:
            layers.append(Conv(tuple(k), ch, out_ch))
            ch = out_ch
        self.layers = nn.ModuleList(layers)
        self.residual = Conv((1,) * len(kernel_sizes[0]), in_ch, out_ch)
        self.activation = activation

    def forward(self, xs):
        """``xs``: one tensor or a list treated as an implicit channel
        concat."""
        xs = list(xs) if isinstance(xs, (list, tuple)) else [xs]
        act = _ACTIVATIONS[self.activation]
        n = len(self.layers)
        out = None
        for i, layer in enumerate(self.layers):
            between = i < n - 1
            fuse = between and self.activation == "relu"
            out = conv_split(xs if i == 0 else [out], layer, relu=fuse)
            if between and not fuse:
                out = act(out)
        # the 1x1 residual commutes with the centre crop: crop first (under
        # int8 each part's scale still comes from its uncropped input)
        target = out.shape[1:-1]
        res = conv_split([center_crop(x, target) for x in xs], self.residual, scale_of=xs)
        return act(out.add_(res))


def max_pool(x, factors: Sequence[int]):
    for d, f in enumerate(factors):
        if x.shape[1 + d] % f:
            raise ValueError(
                f"cannot downsample spatial shape {tuple(x.shape[1:-1])} "
                f"by {tuple(factors)}: dim {d} not divisible"
            )
    y = F.max_pool3d(x.permute(0, 4, 1, 2, 3), tuple(factors), tuple(factors))
    return to_channels_last(y)


def upsample_resize(x, factors: Sequence[int]):
    """Trilinear upsampling, ``align_corners=False`` (equal to
    ``jax.image.resize(..., "linear")`` for integer factors)."""
    size = tuple(s * f for s, f in zip(x.shape[1:-1], factors))
    y = F.interpolate(
        x.permute(0, 4, 1, 2, 3), size=size, mode="trilinear", align_corners=False
    )
    return to_channels_last(y)


def crop_to_factor(x, factor, kernel_sizes):
    """Crop so (spatial - conv_crop) is a multiple of ``factor``."""
    dims = len(factor)
    spatial = tuple(x.shape[1 : 1 + dims])
    conv_crop = tuple(sum(k[d] - 1 for k in kernel_sizes) for d in range(dims))
    ns = tuple((s - c) // f for s, c, f in zip(spatial, conv_crop, factor))
    target = tuple(n * f + c for n, c, f in zip(ns, conv_crop, factor))
    if target != spatial:
        if not all(t > c for t, c in zip(target, conv_crop)):
            raise ValueError(
                f"feature map {spatial} too small for factor {factor} "
                f"and convs {kernel_sizes}"
            )
        return center_crop(x, target)
    return x


class UNet(nn.Module):
    """ReLU U-Net with constant (trilinear) upsampling and one decoder.  A
    2D config is lifted (``lift_2d_config``): ``cfg`` is then the 3D one."""

    def __init__(self, cfg: UNetConfig):
        super().__init__()
        if cfg.dims == 2:
            cfg = lift_2d_config(cfg)
        elif cfg.dims != 3:
            raise ValueError(f"a U-Net of {cfg.dims} spatial dims; 2 or 3 are built")
        self.cfg = cfg
        nf, inc, n = cfg.num_fmaps, cfg.fmap_inc_factor, cfg.num_levels
        self.l_conv = nn.ModuleList(
            ConvPass(
                cfg.in_channels if level == 0 else nf * inc ** (level - 1),
                nf * inc**level,
                cfg.kernel_size_down[level],
            )
            for level in range(n)
        )
        # one decoder, kept one list deep like the JAX params' r_conv[head]
        self.r_conv = nn.ModuleList(
            [
                nn.ModuleList(
                    ConvPass(
                        nf * inc**level + nf * inc ** (level + 1),
                        cfg.num_fmaps_out
                        if cfg.num_fmaps_out is not None and level == 0
                        else nf * inc**level,
                        cfg.kernel_size_up[level],
                    )
                    for level in range(n - 1)
                )
            ]
        )

    def forward(self, x):
        """x: (N, D, H, W, C) -> the decoder's output features."""
        return self._rec(self.cfg.num_levels - 1, x)

    def _rec(self, level, f_in):
        cfg = self.cfg
        i = cfg.num_levels - level - 1
        f_left = self.l_conv[i](f_in)
        if level == 0:
            return f_left
        g = self._rec(level - 1, max_pool(f_left, cfg.downsample_factors[i]))
        g_up = upsample_resize(g, cfg.downsample_factors[i])
        g_up = crop_to_factor(g_up, cfg.crop_factors[i], cfg.kernel_size_up[i])
        f_crop = center_crop(f_left, g_up.shape[1:-1])
        return self.r_conv[0][i]([f_crop, g_up])


# ---------------------------------------------------------------------------
# static shape algebra (for ROI bookkeeping without running the net)
# ---------------------------------------------------------------------------


def compute_output_shape(cfg: UNetConfig, input_shape: Sequence[int]) -> tuple:
    """Spatial output shape of the U-Net for a spatial input shape."""

    def conv_crop(shape, kernels):
        for k in kernels:
            shape = [s - (kk - 1) for s, kk in zip(shape, k)]
            if any(s <= 0 for s in shape):
                raise ValueError("input too small")
        return shape

    def down(shape, f):
        if any(s % ff for s, ff in zip(shape, f)):
            raise ValueError(f"shape {shape} not divisible by {f} at downsample")
        return [s // ff for s, ff in zip(shape, f)]

    def rec(level, shape):
        i = cfg.num_levels - level - 1
        shape = conv_crop(shape, cfg.kernel_size_down[i])
        if level == 0:
            return shape
        inner = rec(level - 1, down(shape, cfg.downsample_factors[i]))
        up = [s * f for s, f in zip(inner, cfg.downsample_factors[i])]
        cc = [sum(k[d] - 1 for k in cfg.kernel_size_up[i]) for d in range(len(up))]
        up = [((s - c) // f) * f + c for s, c, f in zip(up, cc, cfg.crop_factors[i])]
        return conv_crop(up, cfg.kernel_size_up[i])

    return tuple(rec(cfg.num_levels - 1, list(input_shape)))


def min_input_shape(cfg: UNetConfig, start: Optional[Sequence[int]] = None):
    """Smallest valid input shape >= start (elementwise search)."""
    shape = list(start) if start is not None else [1] * cfg.dims
    for _ in range(4096):
        try:
            compute_output_shape(cfg, shape)
            return tuple(shape)
        except ValueError:
            shape = [s + 1 for s in shape]
    raise RuntimeError("no valid input shape found")
