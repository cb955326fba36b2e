"""The plain reference of the residual valid-convolution U-Net setups.

Written from the published description of the bootstrapper setups
(``bootstrapper/models/*/net_config.json``; funkelab's residual U-Net):
per level a conv pass ``act(conv_k(relu(conv_k(x))) + conv_1x1(crop(x)))``
with ReLU, max-pool down, trilinear upsampling (``align_corners=False``),
the upsampled map cropped so that the following valid convs stay on the
pooling grid, the skip centre-cropped to it and concatenated before it,
then one 1x1 conv pass with a sigmoid per output head.  A 2D net is the
same net with a unit z axis and its ``adj_slices`` sections as input
channels.

Plain PyTorch in fp32 (TF32 off) on channels-first ``(N, C, D, H, W)``
tensors, from a dictionary of DHWIO weights (``bmk/weights.py`` names).
It imports nothing of the program.  ``quantize="int8"`` is the control,
the reference one precision below the bf16 the setups run in: every
conv's input and weight rounded to int8 with a symmetric per-tensor scale
(``amax / 127``), and in a backward pass the gradient reaching each conv's
output rounded so too; the roundings pass gradients through unchanged.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _round_int8(x):
    scale = x.abs().amax().clamp(min=1e-30) / 127.0
    return torch.clamp(torch.round(x / scale), -127, 127) * scale


def _int8(x):
    """``x`` rounded to int8, the gradient passed through."""
    return x + (_round_int8(x.detach()) - x).detach()


class _Int8Grad(torch.autograd.Function):
    """The identity, whose backward rounds the incoming gradient to int8."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _round_int8(g)


def _lift(k, dims):
    return tuple(k) if dims == 3 else (1, *k)


class Shape:
    """The net's sizes from a net config (2D lifted to 3D)."""

    def __init__(self, net_config: dict):
        nc = net_config
        self.dims = len(nc["input_shape"])
        in_ch = nc.get("in_channels")
        if in_ch is None:
            in_ch = sum(i["dims"] for i in nc["inputs"].values())
        elif "adj_slices" in nc:
            in_ch *= nc["adj_slices"]
        self.in_channels = in_ch
        self.factors = [_lift(f, self.dims) for f in nc["downsample_factors"]]
        self.k_up = [[_lift(k, self.dims) for k in lvl] for lvl in nc["kernel_size_up"]]
        self.levels = len(self.factors) + 1
        self.heads = list(nc["outputs"])
        prod, crop = None, []
        for f in self.factors[::-1]:
            prod = list(f) if prod is None else [a * b for a, b in zip(f, prod)]
            crop.append(prod)
        self.crop_factors = crop[::-1]


def center_crop(x, target):
    off = [(s - t) // 2 for s, t in zip(x.shape[2:], target)]
    return x[(slice(None), slice(None)) + tuple(slice(o, o + t) for o, t in zip(off, target))]


class UNetReference:
    """``forward(x)``: ``(N, C_in, D, H, W)`` fp32 -> ``{head: (N, C, D',
    H', W')}`` sigmoid outputs.  ``weights``: ``{name: DHWIO or bias
    tensor}``; with ``requires_grad`` leaves the forward is differentiable."""

    def __init__(self, net_config: dict, weights: dict, quantize: Optional[str] = None):
        self.shape = Shape(net_config)
        self.w = weights
        if quantize not in (None, "int8"):
            raise ValueError(f"quantize must be None or 'int8', not {quantize!r}")
        self.quantize = quantize

    def conv(self, x, name):
        w = self.w[name + ".w"].permute(4, 3, 0, 1, 2)  # DHWIO -> OIDHW
        if self.quantize == "int8":
            return _Int8Grad.apply(F.conv3d(_int8(x), _int8(w), self.w[name + ".b"]))
        return F.conv3d(x, w, self.w[name + ".b"])

    def conv_pass(self, x, prefix, n_layers, act=torch.relu):
        h = x
        for i in range(n_layers):
            h = self.conv(h, f"{prefix}.layers.{i}")
            if i < n_layers - 1:
                h = torch.relu(h)
        res = self.conv(center_crop(x, h.shape[2:]), f"{prefix}.residual")
        return act(h + res)

    def crop_to_factor(self, x, factor, kernels):
        conv_crop = [sum(k[d] - 1 for k in kernels) for d in range(3)]
        spatial = x.shape[2:]
        target = [((s - c) // f) * f + c for s, c, f in zip(spatial, conv_crop, factor)]
        return center_crop(x, target) if list(target) != list(spatial) else x

    def level(self, level, x):
        s = self.shape
        i = s.levels - level - 1
        f_left = self.conv_pass(x, f"unet.l_conv.{i}", 2)
        if level == 0:
            return f_left
        g = self.level(level - 1, F.max_pool3d(f_left, s.factors[i], s.factors[i]))
        size = [a * b for a, b in zip(g.shape[2:], s.factors[i])]
        g_up = F.interpolate(g, size=size, mode="trilinear", align_corners=False)
        g_up = self.crop_to_factor(g_up, s.crop_factors[i], s.k_up[i])
        f_crop = center_crop(f_left, g_up.shape[2:])
        return self.conv_pass(torch.cat([f_crop, g_up], 1), f"unet.r_conv.0.{i}", len(s.k_up[i]))

    def forward(self, x) -> dict:
        z = self.level(self.shape.levels - 1, x)
        return {h: self.conv_pass(z, f"heads.{h}", 1, act=torch.sigmoid) for h in self.shape.heads}


def edge_reach(net_config: dict) -> list:
    """Per spatial axis (z, y, x of the lifted net), how many output voxels
    from an edge of a forward's output its values depend on where that
    edge lies: each linear upsample by a factor over 1 reads one voxel of
    the level below past the one it refines, that is the product of the
    factors down to that level in voxels of the input, and the valid
    context holds the rest."""
    s = Shape(net_config)
    reach = [0, 0, 0]
    prod = [1, 1, 1]
    for f in s.factors:
        prod = [a * b for a, b in zip(prod, f)]
        for d in range(3):
            if f[d] > 1:
                reach[d] += prod[d]
    return reach
