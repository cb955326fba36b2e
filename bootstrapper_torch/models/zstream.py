"""Overlap-save z-streaming through the port's U-Net (the JAX package's
``models/zstream.py``, plain decoder only).

Nets that never pool z keep full z resolution at every level, and each
valid conv consumes ``k_z - 1`` slices.  Instead of recomputing the z
context for every tile, a stream feeds ``s`` new z slices per step and
every level keeps a small cache:

- per level, the trailing ``_dz`` slices of that level's input, so its
  conv pass sees exactly its context again;
- per decoder level, a skip FIFO of constant length (the encoder runs
  ahead of the decoder by the z lag of the deeper levels), and the
  trailing slices of the lower level's output (``g``).

The first (warm) step takes an input with the full z context; each later
step takes ``s`` slices and emits ``s`` output slices, equal to the
forward on the concatenated input (valid convs are exact under
concatenation).  State, in the JAX package's layout::

    {"enc": [tail per level], "dec_f": [FIFO per decoder level],
     "dec_g": [[g tail per decoder level]]}   # one list per head

Each cached tensor is a copy of its slices, never a view of a step's
concatenation, so a step's full activations are freed when it ends; and
a concatenation is laid out by ``empty_channels_last``, so that the conv
kernel reads it through its tensor map.  The TPU fold, lazy-decode and
z-slab forms of the JAX package are layout work and are not ported.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.conv3d import empty_channels_last
from .unet import UNet, UNetConfig, center_crop, crop_to_factor, max_pool, upsample_resize


def stream_eligible(cfg: UNetConfig) -> bool:
    """z streaming applies to 3D nets that never pool z and upsample by
    resampling (the step runs ``upsample_resize``); a transposed-upsample
    net is predicted tiled, as the JAX package declines it too."""
    return cfg.dims == 3 and cfg.constant_upsample and all(f[0] == 1 for f in cfg.downsample_factors)


def _dz(kernels) -> int:
    """z context consumed by one conv pass."""
    return sum(k[0] - 1 for k in kernels)


def z_context(cfg: UNetConfig) -> int:
    """Total z context of the net (input z - output z)."""
    return sum(_dz(k) for k in cfg.kernel_size_down) + sum(_dz(k) for k in cfg.kernel_size_up)


def _cat_z(cache: Optional[torch.Tensor], new: torch.Tensor) -> torch.Tensor:
    """``cache`` and ``new`` joined along z, on 16-byte voxel lines."""
    if cache is None:
        return new
    n, zc = cache.shape[:2]
    out = empty_channels_last((n, zc + new.shape[1], *new.shape[2:]), new.dtype, new.device)
    out[:, :zc].copy_(cache)
    out[:, zc:].copy_(new)
    return out


def _tail(x: torch.Tensor, n: int) -> torch.Tensor:
    """A copy of the last ``n`` z slices of ``x`` (never a view, which
    would keep all of ``x`` alive)."""
    return x[:, x.shape[1] - n :].clone()


def unet_stream_step(unet: UNet, x: torch.Tensor, state: Optional[dict]):
    """One z-streaming step.  Returns ``([decoder output], new state)``.

    ``state=None`` is the warm step: ``x`` carries the full z context
    (output z = input z - ``z_context``).  Later steps take ``s`` new z
    slices and emit ``s`` output slices."""
    cfg = unet.cfg
    if not stream_eligible(cfg):
        raise ValueError("config not eligible for z streaming")
    L = cfg.num_levels
    warm = state is None
    new_state = {"enc": [None] * L, "dec_f": [None] * (L - 1), "dec_g": [[None] * (L - 1)]}

    # encoder: each level caches the z tail of its own input
    cur = x
    skips = []
    for i in range(L):
        cat = _cat_z(None if warm else state["enc"][i], cur)
        new_state["enc"][i] = _tail(cat, _dz(cfg.kernel_size_down[i]))
        f_left = unet.l_conv[i](cat)
        skips.append(f_left)
        if i < L - 1:
            cur = max_pool(f_left, cfg.downsample_factors[i])

    # decoder: g-context cache and a constant-length skip FIFO
    g = skips[L - 1]
    for i in range(L - 2, -1, -1):
        dz = _dz(cfg.kernel_size_up[i])
        f_cat = _cat_z(None if warm else state["dec_f"][i], skips[i])
        g_cat = _cat_z(None if warm else state["dec_g"][0][i], g)
        e_g, e_f = g_cat.shape[1], f_cat.shape[1]
        if warm:
            # the static graph centre-crops the skip in z; the FIFO keeps
            # everything from the next step's window start on: a constant
            # length from here
            off = (e_f - e_g) // 2
            fifo = (e_f - e_g) - off + dz
            f_win = f_cat[:, off : off + e_g]
        else:
            # steady: the window is the oldest e_g slices of FIFO + new
            fifo = state["dec_f"][i].shape[1]
            f_win = f_cat[:, :e_g]
        new_state["dec_g"][0][i] = _tail(g_cat, dz)
        new_state["dec_f"][i] = _tail(f_cat, fifo)
        g_up = upsample_resize(g_cat, cfg.downsample_factors[i])
        g_up = crop_to_factor(g_up, cfg.crop_factors[i], cfg.kernel_size_up[i])
        g = unet.r_conv[0][i]([center_crop(f_win, g_up.shape[1:-1]), g_up])
    return [g], new_state
