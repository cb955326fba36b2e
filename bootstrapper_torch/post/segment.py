"""In-memory segmentation (the JAX package's ``post/segment.py``): ws
(watershed fragments -> agglomeration -> labels at each threshold), mws
(mutex watershed over the long-range affinities) and cc (connected
components of the thresholded direct-neighbour affinities).  Everything
but ws's seed kernel runs in the native C++ library on the host."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from .. import native
from .fragments import cc_from_affinities, mutex_watershed_from_affinities, watershed_from_affinities

DEFAULT_THRESHOLDS = [0.2, 0.35, 0.5]

#: ws-mode defaults (reference ``bootstrapper/segment.py:10-55``)
WS_DEFAULTS = {
    "fragments_in_xy": True,
    "min_seed_distance": 10,
    "thresholds": DEFAULT_THRESHOLDS,
    "merge_function": "mean",
}


def segmentation_from_merge_scores(
    fragments: np.ndarray,
    edges_u: np.ndarray,
    edges_v: np.ndarray,
    merge_scores: np.ndarray,
    threshold: float,
) -> np.ndarray:
    """Relabel fragments by joining every edge whose merge score <=
    threshold (waterz-threshold semantics via the merge history)."""
    ids = np.unique(fragments)
    ids = ids[ids != 0]
    if len(ids) == 0:
        return fragments.copy()
    du = np.searchsorted(ids, np.asarray(edges_u, np.uint64)).astype(np.uint64)
    dv = np.searchsorted(ids, np.asarray(edges_v, np.uint64)).astype(np.uint64)
    comps = native.connected_components_edges(len(ids), du, dv, merge_scores, threshold)
    lut_new = ids[comps.astype(np.int64)]  # representative original id
    return native.replace_values(fragments, ids, lut_new)


def waterz_segmentation(
    affs: np.ndarray,
    thresholds: Sequence[float] = DEFAULT_THRESHOLDS,
    merge_function: str = "mean",
    fragments_in_xy: bool = True,
    min_seed_distance: int = 10,
    device=None,
) -> dict:
    """Watershed fragments + hierarchical agglomeration threshold sweep:
    ``{threshold: labels}``.  uint8 affinities are read as value/255."""
    integer_scaled = np.issubdtype(np.asarray(affs).dtype, np.integer)
    affs = np.asarray(affs, np.float32)
    if integer_scaled:
        affs = affs / 255.0
    # only the direct-neighbour channels drive watershed + agglomeration
    affs = affs[:3]
    fragments, _ = watershed_from_affinities(
        affs,
        fragments_in_xy=fragments_in_xy,
        min_seed_distance=min_seed_distance,
        device=device,
    )
    eu, ev, es, _ = native.agglomerate(
        fragments, affs, threshold=max(thresholds), merge_function=merge_function
    )
    return {
        t: segmentation_from_merge_scores(fragments, eu, ev, es, t) for t in thresholds
    }


def mws_segmentation(
    affs: np.ndarray,
    neighborhood: Sequence[Sequence[int]],
    bias: Sequence[float],
    sigma: Optional[Sequence[int]] = (0, 3, 3),
    noise_eps: Optional[float] = 0.001,
    strides: Optional[Sequence[Sequence[int]]] = None,
    randomized_strides: bool = False,
    remove_debris: int = 0,
) -> np.ndarray:
    """Mutex-watershed segmentation (the reference's ``mws`` mode with
    its 9-offset neighborhood + bias defaults, ``segment.py:26-55``)."""
    integer_scaled = np.issubdtype(np.asarray(affs).dtype, np.integer)
    affs = np.asarray(affs, np.float32)
    if integer_scaled:
        affs = affs / 255.0
    seg = mutex_watershed_from_affinities(
        affs,
        neighborhood,
        bias,
        sigma=sigma,
        noise_eps=noise_eps,
        strides=strides,
        randomized_strides=randomized_strides,
    )
    if remove_debris:
        seg = remove_small_segments(seg, remove_debris)
    return seg


def cc_segmentation(
    affs: np.ndarray, threshold: float = 0.5, remove_debris: int = 0
) -> np.ndarray:
    """Thresholded-affinity connected components (the reference's ``cc``
    mode)."""
    integer_scaled = np.issubdtype(np.asarray(affs).dtype, np.integer)
    affs = np.asarray(affs, np.float32)
    if integer_scaled:
        affs = affs / 255.0
    seg = cc_from_affinities(affs, threshold)
    if remove_debris:
        seg = remove_small_segments(seg, remove_debris)
    return seg


def remove_small_segments(seg: np.ndarray, min_size: int) -> np.ndarray:
    ids, counts = np.unique(seg, return_counts=True)
    kill = ids[(counts < min_size) & (ids != 0)]
    if len(kill) == 0:
        return seg
    return native.replace_values(seg, kill, np.zeros(len(kill), np.uint64))


# -- method defaults (reference ``bootstrapper/segment.py:10-55``) ----------

MWS_DEFAULT_NEIGHBORHOOD = [
    [-1, 0, 0], [0, -1, 0], [0, 0, -1],
    [-2, 0, 0], [0, -9, 0], [0, 0, -9],
    [-3, 0, 0], [0, -27, 0], [0, 0, -27],
]
MWS_DEFAULT_BIAS = [-0.4, -0.4, -0.4, -0.7, -0.7, -0.7, -0.7, -0.7, -0.7]
MWS_DEFAULT_STRIDES = (
    [[1, 1, 1]] * 3 + [[2, 9, 9]] * 3 + [[3, 27, 27]] * 3
)

METHOD_DEFAULTS = {
    "ws": WS_DEFAULTS,
    "mws": {
        "neighborhood": MWS_DEFAULT_NEIGHBORHOOD,
        "bias": MWS_DEFAULT_BIAS,
        "sigma": None,
        "noise_eps": 0.001,
        "strides": MWS_DEFAULT_STRIDES,
        "randomized_strides": True,
        "remove_debris": 64,
        # the blockwise path's (adj, lr) operating points, swept over one
        # fragments + RAG run; the in-memory path takes ``bias_sweep``
        "global_bias_sweep": [[-0.4, -0.7], [-0.55, -0.8], [-0.7, -0.9]],
    },
    "cc": {"threshold": 0.5, "remove_debris": 64},
}
