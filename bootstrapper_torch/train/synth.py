"""Synthetic label generation for the ``3d_affs_from_*`` refiner models.

Capability parity with the reference's CreateLabels / ObfuscateLabels
gunpowder providers (reference ``bootstrapper/gp/create_labels.py:21-178``,
``gp/obfuscate_labels.py:10-143``): the refiners train *purely on
synthetic labels* — random 3D segmentations plus simulated 2D prediction
errors — so they transfer across datasets.

Host-side numpy/scipy (label topology work: connected components, EDT,
Voronoi assignment); the resulting label volumes feed the device
pipeline which derives inputs (2D LSDs/affs of the obfuscated copy) and
targets (3D affs of the clean labels) on the card.  A copy of the JAX
package's ``train/synth.py``: the same numpy seed gives the same pair.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
from scipy import ndimage


def _voronoi_labels(seeds: np.ndarray) -> np.ndarray:
    """Assign every voxel the label of its nearest seed (EDT feature
    transform)."""
    background = seeds == 0
    idx = ndimage.distance_transform_edt(
        background, return_distances=False, return_indices=True
    )
    return seeds[tuple(idx)]


def create_labels(
    rng: np.random.Generator,
    shape: Tuple[int, ...] = (40, 196, 196),
    mode: Optional[str] = None,
    anisotropy_range=(2, 8),
    p_blackout: float = 0.2,
    num_points_range=(20, 60),
    sigma: Optional[float] = None,
) -> np.ndarray:
    """Random 3D instance segmentation.

    - 'random' mode: smoothed noise -> local-maxima seeds -> Voronoi
      regions (the reference's noise-watershed equivalent); ``sigma``
      (default drawn uniform(4, 10)) sets the seed spacing and thereby
      the object scale;
    - 'tubes' mode: random thick line segments -> connected components
      -> nearest-label expansion;
    then random id blackout and z-subsampling by a random anisotropy
    factor (EM stacks are anisotropic; generated dense, then strided).

    All scalar parameters are drawn BEFORE any shape-sized RNG
    consumption, so a given seed produces the same object statistics at
    any volume size (a (48,512,512) and a (125,1250,1250) volume from
    the same seed used to land on different ends of the sigma range).
    """
    if mode is None:
        mode = rng.choice(["random", "tubes"])
    aniso = int(rng.integers(*anisotropy_range))
    if sigma is None:
        sigma = float(rng.uniform(4.0, 10.0))
    dense_shape = (shape[0], *shape[1:])

    if mode == "random":
        noise = rng.normal(size=dense_shape).astype(np.float32)
        smooth = ndimage.gaussian_filter(noise, sigma=(sigma / aniso, sigma, sigma))
        maxima = (
            ndimage.maximum_filter(smooth, size=(3, 9, 9)) == smooth
        )
        seeds, _ = ndimage.label(maxima)
        labels = _voronoi_labels(seeds.astype(np.int32))
    elif mode == "tubes":
        canvas = np.zeros(dense_shape, np.int32)
        n = int(rng.integers(*num_points_range))
        for i in range(1, n + 1):
            p0 = rng.uniform(0, 1, 3) * np.array(dense_shape)
            direction = rng.normal(size=3)
            direction /= np.linalg.norm(direction) + 1e-6
            length = rng.uniform(0.2, 0.8) * min(dense_shape)
            steps = int(length)
            ts = np.linspace(0, length, max(steps, 2))
            pts = (p0[None] + ts[:, None] * direction[None]).astype(int)
            ok = np.all((pts >= 0) & (pts < np.array(dense_shape)), axis=1)
            pts = pts[ok]
            if len(pts):
                canvas[tuple(pts.T)] = i
        radius = float(rng.uniform(1.5, 4.0))
        dil = ndimage.distance_transform_edt(canvas == 0) <= radius
        tube_mask = dil | (canvas > 0)
        cc, _ = ndimage.label(tube_mask)
        labels = _voronoi_labels(
            np.where(tube_mask, cc, 0).astype(np.int32)
        )
    else:
        raise ValueError(f"unknown mode {mode!r}")

    # random blackout of some ids -> background holes
    ids = np.unique(labels)
    ids = ids[ids != 0]
    if len(ids) and p_blackout > 0:
        kill = ids[rng.uniform(size=len(ids)) < p_blackout]
        labels[np.isin(labels, kill)] = 0

    # simulate anisotropy: stretch a z-subsampled stack back to shape[0]
    sub = labels[::aniso]
    labels = np.repeat(sub, aniso, axis=0)[: shape[0]]
    if labels.shape[0] < shape[0]:
        pad = shape[0] - labels.shape[0]
        labels = np.concatenate([labels, np.repeat(labels[-1:], pad, axis=0)])
    return labels.astype(np.int32)


def obfuscate_labels(
    rng: np.random.Generator,
    labels: np.ndarray,
    p_split: float = 0.1,
    p_merge: float = 0.1,
    p_artifact: float = 0.1,
) -> np.ndarray:
    """Simulate 2D prediction errors on a copy of ``labels``: per z-slice
    random label *splits* (Voronoi fragments from 2 in-mask seeds),
    *merges* of touching labels, and blob *artifacts*."""
    out = labels.copy()
    next_id = int(out.max()) + 1
    for z in range(out.shape[0]):
        sl = out[z]
        ids = np.unique(sl)
        ids = ids[ids != 0]
        if len(ids) == 0:
            continue

        if rng.uniform() < p_split:
            lid = int(rng.choice(ids))
            mask = sl == lid
            ys, xs = np.nonzero(mask)
            if len(ys) > 4:
                pick = rng.choice(len(ys), 2, replace=False)
                seeds = np.zeros_like(sl)
                seeds[ys[pick[0]], xs[pick[0]]] = lid
                seeds[ys[pick[1]], xs[pick[1]]] = next_id
                vor = _voronoi_labels(seeds)
                sl[mask] = vor[mask]
                next_id += 1

        if rng.uniform() < p_merge and len(ids) >= 2:
            a, b = rng.choice(ids, 2, replace=False)
            # merge only if touching in this slice
            grown = ndimage.binary_dilation(sl == a)
            if (grown & (sl == b)).any():
                sl[sl == b] = a

        if rng.uniform() < p_artifact:
            lid = int(rng.choice(ids))
            cy, cx = rng.uniform(0, 1, 2) * np.array(sl.shape)
            r = rng.uniform(3, 12)
            yy, xx = np.ogrid[: sl.shape[0], : sl.shape[1]]
            blob = (yy - cy) ** 2 + (xx - cx) ** 2 <= r**2
            sl[blob & (sl > 0)] = lid
        out[z] = sl
    return out


def synthetic_pair(
    rng: np.random.Generator,
    shape=(40, 196, 196),
    **obfuscate_kw,
) -> Tuple[np.ndarray, np.ndarray]:
    """(clean_labels, obfuscated_labels) for one refiner training draw."""
    labels = create_labels(rng, shape)
    return labels, obfuscate_labels(rng, labels, **obfuscate_kw)
