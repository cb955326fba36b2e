"""GT metrics: VOI (+ optional skeleton ERL) for a segmentation
(a copy of the JAX package's ``eval/metrics.py``; the skeleton metrics,
which need networkx, are imported only when skeletons are given).

Equivalent of the reference's compute_metrics entry point (reference
``bootstrapper/eval/compute_metrics.py:73-183``): compare a segmentation
Zarr against ground-truth labels and/or skeletons, return one metrics
dict (the evaluate workflow dumps these to JSON per volume).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..core.arrays import Array
from ..core.geometry import Roi
from .voi import rand_voi


def compute_metrics(
    seg: Array,
    gt_labels: Optional[Array] = None,
    gt_skeletons: Optional[str] = None,
    mask: Optional[Array] = None,
    roi: Optional[Roi] = None,
) -> Dict:
    out: Dict = {}
    if gt_labels is not None:
        eval_roi = roi or seg.roi.intersect(gt_labels.roi)
        seg_arr = seg.to_ndarray(eval_roi)
        gt_arr = gt_labels.to_ndarray(eval_roi)
        if mask is not None:
            m = mask.to_ndarray(eval_roi) > 0
            gt_arr = np.where(m, gt_arr, 0)
        scores = rand_voi(gt_arr, seg_arr)
        scores["voi_sum"] = scores["voi_split"] + scores["voi_merge"]
        out["voi"] = scores
    if gt_skeletons is not None:
        # networkx only where skeletons are scored
        from .skeletons import skeleton_metrics

        out["skeletons"] = skeleton_metrics(seg, gt_skeletons)
    return out
