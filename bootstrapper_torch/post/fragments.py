"""Fragments from affinities (the JAX package's ``post/fragments.py``):
seeded watershed, mutex watershed and connected components.

Watershed: boundary mask = mean affinity > half of
``max_affinity_value``, its Euclidean distance transform, seeds at the
maxima of the max-filtered distance, then the native seeded priority-flood
watershed.  With ``fragments_in_xy`` (the default of the
ws pipeline) every z-section is its own 2D problem and the seeds of the
whole stack come from one call of the seed kernel on ``device``
(``ops/seeds.py``); on CUDA the kernel runs or the call raises.

Mutex watershed and connected components are copies of the JAX package's
and run on the host only, in the native library (``native/post.cpp``), so
both packages give the same labels.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from scipy import ndimage

from .. import native, resolve_device
from ..ops.seeds import seed_maxima_3d


def device_seed_maxima(dist_stack: np.ndarray, mask_stack: np.ndarray, size, device):
    """Per-section seeds of a (Z, H, W) stack, computed on ``device``."""
    dev = resolve_device(device)
    dist = torch.from_numpy(np.ascontiguousarray(dist_stack, np.float32)).to(dev)
    mask = torch.from_numpy(np.ascontiguousarray(mask_stack)).to(dev)
    return seed_maxima_3d(dist, mask, size).cpu().numpy().astype(bool)


def watershed_from_affinities(
    affs: np.ndarray,
    fragments_in_xy: bool = False,
    min_seed_distance: int = 10,
    max_affinity_value: float = 1.0,
    return_seeds: bool = False,
    device=None,
):
    """Seeded watershed fragments.  ``affs``: (C, Z, Y, X) float in
    [0, ``max_affinity_value``].  ``fragments_in_xy``: per-section 2D
    fragments from the mean of the two xy channels, with per-section id
    offsets.  Returns ``(fragments, n_fragments)``, and the labelled seeds
    as a third item with ``return_seeds``."""
    affs = np.asarray(affs, np.float32)

    def single(mean_affs, id_offset=0, maxima=None, dist=None):
        boundary_mask = mean_affs > 0.5 * max_affinity_value
        if dist is None:
            dist = ndimage.distance_transform_edt(boundary_mask).astype(np.float32)
        if maxima is None:
            maxima = ndimage.maximum_filter(dist, min_seed_distance) == dist
            maxima &= boundary_mask
        seeds, n = ndimage.label(maxima)
        seeds = seeds.astype(np.uint64)
        if n == 0:
            return np.zeros(mean_affs.shape, np.uint64), id_offset, seeds
        seeds[seeds != 0] += id_offset
        frags = native.watershed_seeded(
            dist.max() - dist, seeds, boundary_mask.astype(np.uint8)
        )
        return frags, id_offset + n, seeds

    if fragments_in_xy:
        mean_affs = 0.5 * (affs[-1] + affs[-2])
        boundary_stack = mean_affs > 0.5 * max_affinity_value
        dist_stack = np.stack(
            [
                ndimage.distance_transform_edt(boundary_stack[z]).astype(np.float32)
                for z in range(mean_affs.shape[0])
            ]
        )
        maxima_stack = device_seed_maxima(
            dist_stack, boundary_stack, min_seed_distance, device
        )
        fragments = np.zeros(mean_affs.shape, np.uint64)
        seeds = np.zeros(mean_affs.shape, np.uint64)
        id_offset = 0
        for z in range(mean_affs.shape[0]):
            fragments[z], id_offset, seeds[z] = single(
                mean_affs[z], id_offset, maxima=maxima_stack[z], dist=dist_stack[z]
            )
    else:
        fragments, id_offset, seeds = single(affs.mean(axis=0))
    if return_seeds:
        return fragments, id_offset, seeds
    return fragments, id_offset


def _grid_edges(shape, neighborhood, strides=None, randomized=False,
                rng=None):
    """Edge lists (u, v, channel) for offset neighborhoods on a flat
    grid. Long-range channels may be subsampled by strides.
    v = u + flat offset, so only the source indices are materialised."""
    n = int(np.prod(shape))
    idx = np.arange(n).reshape(shape)
    flat = [int(np.prod(shape[d + 1 :])) for d in range(len(shape))]
    us, vs, cs = [], [], []
    for c, off in enumerate(neighborhood):
        src = [slice(max(0, -o), min(s, s - o)) for o, s in zip(off, shape)]
        doff = int(sum(o * f for o, f in zip(off, flat)))
        u = idx[tuple(src)]
        if strides is not None and max(abs(o) for o in off) > 1:
            st = strides[c] if isinstance(strides[0], (list, tuple)) else strides
            if randomized and rng is not None:
                u = u.ravel()
                keep = rng.random(u.shape, dtype=np.float32) < np.float32(
                    1.0 / np.prod(st)
                )
                u = u[keep]
            else:
                u = u[tuple(slice(None, None, s) for s in st)]
        u = u.ravel()
        us.append(u)
        vs.append(u + doff)
        cs.append(np.full(u.size, c, np.int32))
    return (
        np.concatenate(us).astype(np.uint64),
        np.concatenate(vs).astype(np.uint64),
        np.concatenate(cs),
    )


def mutex_watershed_from_affinities(
    affs: np.ndarray,
    neighborhood: Sequence[Sequence[int]],
    bias: Sequence[float],
    sigma: Optional[Sequence[int]] = None,
    noise_eps: Optional[float] = None,
    strides: Optional[Sequence[Sequence[int]]] = None,
    randomized_strides: bool = False,
    seed: int = 0,
) -> np.ndarray:
    """Mutex watershed fragments (mws capability): the affinity "shift"
    (noise + smoothed-affs bias + per-channel bias) reproduces the
    reference preprocessing (``post/mws.py:12-59``); the signed weights
    then drive the native sorted-edge mutex clustering.

    Weight prep is per-EDGE, not per-grid-cell: each (channel, voxel)
    pair sources at most one edge, so gathering float32 affinities
    first and adding bias/noise to the gathered weights is equivalent
    to the reference's full-grid shift — without the C*volume float64
    temporaries (the grid is ~3x larger than the edge list under the
    default strides)."""
    affs = np.asarray(affs, np.float32)
    rng = np.random.default_rng(seed)

    if sigma is not None:
        # the reference's shift formulation (affs + (smoothed - affs),
        # ``post/mws.py:46-47``) collapses to the smoothed field itself:
        # sigma fully replaces the affinities (off in shipped defaults)
        affs = ndimage.gaussian_filter(affs, sigma=(0, *sigma))

    shape = affs.shape[1:]
    if len(shape) == 3 and int(np.prod(shape)) < 2**32:
        # fast path: edge generation + weights + sort + clustering +
        # densify all in one native pass (the numpy edge-list math below
        # costs ~10x the clustering itself on slow hosts)
        st, rd = [], []
        for ci, off in enumerate(neighborhood):
            long_range = max(abs(o) for o in off) > 1
            if strides is not None and long_range:
                s = (
                    strides[ci]
                    if isinstance(strides[0], (list, tuple))
                    else strides
                )
                st.append(list(s))
                rd.append(1 if randomized_strides else 0)
            else:
                st.append([1, 1, 1])
                rd.append(0)
        labels, _ = native.mutex_watershed_dense(
            affs, neighborhood, bias, st, rd,
            noise_eps=0.0 if noise_eps is None else float(noise_eps),
            seed=seed,
        )
        return labels

    u, v, c = _grid_edges(
        shape, neighborhood, strides, randomized_strides, rng
    )
    w = affs.reshape(len(neighborhood), -1)
    # weight of edge (u -> u+off) read at the source voxel of channel c
    ew = w[c, u].astype(np.float64)
    ew += np.asarray(bias, np.float64)[c]
    if noise_eps is not None:
        ew += rng.standard_normal(ew.size) * noise_eps
    labels = native.mutex_watershed_edges(int(np.prod(shape)), u, v, ew)
    # densify cluster roots to 1..K
    frags = labels.reshape(shape)
    uniq, dense = np.unique(frags, return_inverse=True)
    return (dense.reshape(shape) + 1).astype(np.uint64)


def cc_from_affinities(
    affs: np.ndarray, threshold: float = 0.5
) -> np.ndarray:
    """Connected components over thresholded direct-neighbour affinities
    (cc capability): affs (3, Z, Y, X) -> labels (Z, Y, X).

    Affinity channels follow the [-1,0,0]/[0,-1,0]/[0,0,-1] convention
    (edge to the *previous* voxel stored at v); the native kernel links
    forward, so channels are shifted by one voxel along their axis.
    """
    hard = (np.asarray(affs[:3]) > threshold).astype(np.uint8)
    fwd = np.zeros_like(hard)
    for c in range(3):
        src = [slice(None)] * 3
        dst = [slice(None)] * 3
        src[c] = slice(1, None)
        dst[c] = slice(None, -1)
        fwd[c][tuple(dst)] = hard[c][tuple(src)]
    return native.cc_from_hard_affs(fwd)
