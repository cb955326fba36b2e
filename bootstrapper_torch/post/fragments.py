"""Watershed fragments from affinities (the JAX package's
``post/fragments.py:watershed_from_affinities``, ws mode).

Boundary mask = mean affinity > half of ``max_affinity_value``, its
Euclidean distance transform,
seeds at the maxima of the max-filtered distance, then the native seeded
priority-flood watershed.  With ``fragments_in_xy`` (the default of the
ws pipeline) every z-section is its own 2D problem and the seeds of the
whole stack come from one call of the seed kernel on ``device``
(``ops/seeds.py``); on CUDA the kernel runs or the call raises.
"""

from __future__ import annotations

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
