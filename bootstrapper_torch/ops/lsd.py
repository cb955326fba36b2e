"""Local shape descriptors (LSDs) as separable Gaussian moment blurs (the
JAX package's ``ops/lsd.py``).

For voxel ``v`` with label ``L``, with ``m(u) = [seg(u) == L]`` and the
centred Gaussian ``g``:

    count(v)     = sum_u g(u-v) m(u)
    offset_d(v)  = sum_u g(u-v) (u_d - v_d) m(u) / count
    cov_de(v)    = sum_u g(u-v) (u_d-v_d)(u_e-v_e) m(u) / count
                   - offset_d offset_e

Each sum correlates the one-hot label tensor with a moment kernel
``g(x) x_d^a x_e^b`` (a+b <= 2), separable into 1D kernels from
{g, g*x, g*x^2}; passes are shared along the chain of exponent prefixes,
then each voxel picks its own label's channel.

Layout (channels first): 3D (10) mean offset z,y,x | variance z,y,x |
Pearson zy,zx,yx | size; 2D (6) offset y,x | variance y,x | Pearson yx |
size; normalised to [0, 1] as the JAX package does.

Each 1D 'SAME' correlation is a product with a banded (Toeplitz) matrix
along its axis, in fp32 with TF32 off on the card (TF32 moves the
descriptors by up to ~7e-4).
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch


def gaussian_kernel(sigma_vox: float, order: int, truncate: float = 3.0):
    """1D moment kernel g(x)*x^order, x in voxel units, numpy (static)."""
    radius = max(1, int(truncate * sigma_vox + 0.5))
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    g = np.exp(-0.5 * (x / sigma_vox) ** 2)
    g /= g.sum()
    return (g * x**order).astype(np.float32)


@functools.lru_cache(maxsize=64)
def _band_matrix(sigma_vox: float, order: int, length: int, device: torch.device):
    """``T`` with ``(x @ T.T)[i] = sum_k kernel[k] x[i + k - len//2]``, zero
    outside ``x``: the 'SAME' correlation (no flip) along a last axis."""
    k = gaussian_kernel(sigma_vox, order)
    left = len(k) // 2
    idx = np.arange(length)[None, :] - np.arange(length)[:, None] + left
    band = np.where((idx >= 0) & (idx < len(k)), k[np.clip(idx, 0, len(k) - 1)], 0)
    return torch.from_numpy(band.astype(np.float32)).to(device)


@contextlib.contextmanager
def _full_fp32(device: torch.device):
    """cuBLAS in fp32 (no TF32) inside, the caller's setting restored after."""
    if device.type != "cuda":
        yield
        return
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _conv1d_along(x, sigma_vox: float, order: int, axis: int):
    """'SAME' 1D correlation of ``x`` with ``gaussian_kernel(sigma_vox,
    order)`` along ``axis``."""
    t = _band_matrix(float(sigma_vox), order, x.shape[axis], x.device)
    moved = torch.movedim(x, axis, -1)
    return torch.movedim(moved @ t.T, -1, axis)


def _moment_exponents(dims: int):
    """Ordered exponent tuples: count, first moments, diag second, cross."""
    first = [tuple(1 if i == d else 0 for i in range(dims)) for d in range(dims)]
    diag = [tuple(2 if i == d else 0 for i in range(dims)) for d in range(dims)]
    cross = []
    for d in range(dims):
        for e in range(d + 1, dims):
            cross.append(tuple(1 if i in (d, e) else 0 for i in range(dims)))
    return [tuple([0] * dims)] + first + diag + cross


def _blur_moments(masks, sigmas_vox, pick=None):
    """All <=2nd-order Gaussian moments of each channel of ``masks``
    (``(..., K, *spatial)`` float, the last ``len(sigmas_vox)`` axes
    blurred): dict[exponents] -> ``pick(moment)`` (default: the moment).

    Shares 1D passes down the separable chain: the first spatial axis with
    each needed order, then the next, ... so each moment costs ``dims`` 1D
    passes and common prefixes are computed once.  A prefix's partial
    results are freed once the next axis is done, and each finished moment
    goes through ``pick`` before the next is computed."""
    dims = len(sigmas_vox)
    first_axis = masks.ndim - dims
    wanted = _moment_exponents(dims)
    partial_results = {(): masks}
    out = {}
    for d in range(dims):
        next_results = {}
        orders_needed = {}
        for expts in wanted:
            prefix = expts[: d + 1]
            orders_needed.setdefault(prefix[:-1], set()).add(prefix[-1])
        for prefix, orders in orders_needed.items():
            base = partial_results[prefix]
            for o in sorted(orders):
                r = _conv1d_along(base, sigmas_vox[d], o, first_axis + d)
                if d == dims - 1:
                    out[prefix + (o,)] = r if pick is None else pick(r)
                else:
                    next_results[prefix + (o,)] = r
        partial_results = next_results
    return {e: out[e] for e in wanted}


def _descriptors(seg, sigma, voxel_size, max_labels: int, batch: int):
    """LSDs of ``seg`` (``(*batch, *spatial)`` ints) -> ``(*batch, C,
    *spatial)`` fp32; the ``batch`` leading axes are not blurred."""
    dims = seg.ndim - batch
    if np.isscalar(sigma):
        sigma = (float(sigma),) * dims
    voxel_size = tuple(voxel_size) if voxel_size is not None else (1.0,) * dims
    sigmas_vox = [s / v for s, v in zip(sigma, voxel_size)]

    # ids beyond max_labels merge into the last channel
    seg = torch.clamp(seg.to(torch.int64), max=max_labels - 1)
    idx = seg.unsqueeze(batch)
    onehot = torch.zeros((*seg.shape[:batch], max_labels, *seg.shape[batch:]), dtype=torch.float32, device=seg.device)
    onehot.scatter_(batch, idx, 1.0)

    def pick(m):  # this voxel's own label channel
        return torch.gather(m, batch, idx).squeeze(batch)

    with _full_fp32(seg.device):
        moments = _blur_moments(onehot, sigmas_vox, pick)
    del onehot

    expts = _moment_exponents(dims)
    count = torch.clamp(moments[expts[0]], min=1e-6)
    first = [moments[e] / count for e in expts[1 : 1 + dims]]
    diag = [moments[e] / count for e in expts[1 + dims : 1 + 2 * dims]]
    cross = [moments[e] / count for e in expts[1 + 2 * dims :]]

    # voxel units -> world units
    first = [f * voxel_size[d] for d, f in enumerate(first)]
    diag = [s2 * voxel_size[d] ** 2 for d, s2 in enumerate(diag)]
    cross_pairs = [(d, e) for d in range(dims) for e in range(d + 1, dims)]
    cross = [c * voxel_size[d] * voxel_size[e] for (d, e), c in zip(cross_pairs, cross)]

    variances = [torch.clamp(s2 - f * f, min=0.0) for f, s2 in zip(first, diag)]
    pearsons = []
    for (d, e), c in zip(cross_pairs, cross):
        cov = c - first[d] * first[e]
        denom = torch.sqrt(variances[d] * variances[e]) + 1e-6
        pearsons.append(torch.clamp(cov / denom, -1.0, 1.0))

    channels = [torch.clamp(first[d] / sigma[d], -1.0, 1.0) * 0.5 + 0.5 for d in range(dims)]
    channels += [torch.clamp(variances[d] / sigma[d] ** 2, 0.0, 1.0) for d in range(dims)]
    channels += [p * 0.5 + 0.5 for p in pearsons]
    channels.append(torch.clamp(count, 0.0, 1.0))

    out = torch.stack(channels, dim=batch)
    return torch.where(seg.unsqueeze(batch) > 0, out, 0.0)


def _as_tensor(seg):
    return seg if isinstance(seg, torch.Tensor) else torch.from_numpy(np.asarray(seg))


def lsd_descriptors(seg, sigma, voxel_size=None, max_labels: int = 64):
    """LSDs of a label volume. seg: int (*spatial) with ids in [0,
    max_labels) (a tensor, on the device the work runs on, or an array);
    0 is background. sigma: world units (scalar or per-dim); voxel_size
    defaults to 1s. Returns (C, *spatial) fp32 in [0, 1]."""
    return _descriptors(_as_tensor(seg), sigma, voxel_size, max_labels, batch=0)


def _downsampled(seg, sigma, voxel_size, downsample: int, max_labels: int, batch: int):
    dims = seg.ndim - batch
    if downsample == 1:
        return _descriptors(seg, sigma, voxel_size, max_labels, batch)
    ds = (1,) + (downsample,) * (dims - 1) if dims == 3 else (downsample,) * dims
    voxel_size = tuple(voxel_size) if voxel_size is not None else (1.0,) * dims
    vs_ds = tuple(v * d for v, d in zip(voxel_size, ds))
    sub = seg[(slice(None),) * batch + tuple(slice(None, None, d) for d in ds)]
    desc = _descriptors(sub, sigma, vs_ds, max_labels, batch)
    for ax, d in enumerate(ds):
        if d > 1:
            desc = torch.repeat_interleave(desc, d, dim=batch + 1 + ax)
    return desc[(slice(None),) * (batch + 1) + tuple(slice(0, s) for s in seg.shape[batch:])]


def lsd_descriptors_downsampled(seg, sigma, voxel_size=None, downsample: int = 1, max_labels: int = 64):
    """LSDs on a strided grid ((1, d, d) in 3D, (d, d) in 2D), nearest-
    upsampled back and cropped to ``seg``'s shape."""
    return _downsampled(_as_tensor(seg), sigma, voxel_size, downsample, max_labels, batch=0)


def lsd_descriptors_2d_stack(seg3d, sigma, voxel_size_yx=None, max_labels: int = 64):
    """Per-z-slice 2D LSDs of a 3D label volume, stacked: (6, Z, Y, X).
    The slices are one batch (the JAX package maps over them)."""
    desc = _descriptors(_as_tensor(seg3d), sigma, voxel_size_yx, max_labels, batch=1)
    return torch.movedim(desc, 0, 1)


def calc_max_padding(output_size, voxel_size, sigma, mode: str = "shrink"):
    """Max upstream context needed for LSD targets: 3*sigma plus the xy
    diagonal half, snapped to the voxel grid."""
    from ..core.geometry import Coordinate, Roi

    voxel_size = Coordinate(voxel_size)
    method_padding = Coordinate((0, 3 * sigma, 3 * sigma))
    diag = np.sqrt(output_size[1] ** 2 + output_size[2] ** 2)
    max_padding = Roi(
        (Coordinate([i // 2 for i in [output_size[0], diag, diag]]) + method_padding),
        (0,) * 3,
    ).snap_to_grid(voxel_size, mode=mode)
    return max_padding.begin
