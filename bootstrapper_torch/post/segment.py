"""In-memory ws segmentation: fragments -> agglomeration -> labels at each
threshold (the JAX package's ``post/segment.py``, ws mode).  The
agglomeration and relabelling run in the native C++ library on the
host."""

from __future__ import annotations

from typing import Sequence

import numpy as np

from .. import native
from .fragments import watershed_from_affinities

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
