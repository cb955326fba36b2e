"""Threshold sweeper: score every agglomeration threshold, pick the best
(a copy of the JAX package's ``eval/thresholds.py``, reading the port's
uncompressed Zarr chunks).

Capability parity with the reference's ``EvaluateAnnotations``
(reference ``bootstrapper/eval/evaluate_thresholds.py:28-735``): for
each threshold, derive the fragment->segment LUT from the RAG, map
ground-truth sites (skeleton nodes) and/or voxels through it, and
compute ERL/VOI plus merge/split counts; then report the best
threshold by VOI sum and by NERL.

Efficient design: skeleton nodes are looked up in the *fragments*
volume once; each threshold then only needs the LUT gather (no
segmentation extraction).  Voxel-wise VOI uses one
``replace_values`` over the fragments volume per threshold.  Edit
counts (splits/merges needed) are exact recursive min-cuts over each
merging segment's RAG (``mincut.py``, funlib ``split_graph`` parity).
"""

from __future__ import annotations

import logging
from typing import Dict, Optional, Sequence

import numpy as np

from .. import native
from ..core.arrays import Array
from ..core.geometry import Coordinate
from ..post.rag import RagDB
from .mincut import compute_edits
from .skeletons import (
    _skeleton_components,
    expected_run_length,
    load_skeletons,
)
from .voi import rand_voi

logger = logging.getLogger(__name__)


def batch_point_lookup(array: Array, nodes, positions) -> dict:
    """{node: int(array[pos])} with one read per touched storage chunk
    instead of one read per point.

    ``positions`` are world-unit Coordinates (or None for out-of-ROI
    nodes, which map to 0).  Points are grouped by chunk index; each
    group is served by a single chunk-aligned read and vectorised
    fancy-indexing."""
    vs = np.array(array.voxel_size, np.int64)
    origin = np.array(array.offset, np.int64)
    chunk = np.array(array.store.chunks[-len(vs):], np.int64)
    shape = np.array(array.shape[-len(vs):], np.int64)

    out = {n: 0 for n in nodes}
    vox_by_chunk: dict = {}
    for n, p in zip(nodes, positions):
        if p is None:
            continue
        v = (np.asarray(p, np.int64) - origin) // vs
        key = tuple(v // chunk)
        vox_by_chunk.setdefault(key, []).append((n, v))
    for key, group in vox_by_chunk.items():
        lo = np.array(key, np.int64) * chunk
        hi = np.minimum(lo + chunk, shape)
        block = array.store.read(
            tuple(slice(int(a), int(b)) for a, b in zip(lo, hi))
        )
        vox = np.stack([v for _, v in group]) - lo
        vals = block[tuple(vox.T)]
        for (n, _), val in zip(group, vals):
            out[n] = int(val)
    return out


def evaluate_thresholds(
    fragments: Array,
    rag: RagDB,
    thresholds: Sequence[float],
    gt_labels: Optional[Array] = None,
    gt_skeletons: Optional[str] = None,
    mask: Optional[Array] = None,
    num_workers: int = 1,
) -> Dict:
    node_ids, _ = rag.read_nodes()
    eu, ev, scores = rag.read_edges()
    dense = {int(n): i for i, n in enumerate(node_ids)}
    du = np.array([dense[int(u)] for u in eu], np.uint64)
    dv = np.array([dense[int(v)] for v in ev], np.uint64)

    # one-time site -> fragment lookups, batched by storage chunk: real
    # skeletons have thousands of nodes, and a storage read
    # per node dominates the sweep (reference reads whole blocks too,
    # evaluate_thresholds.py site lookup)
    skels = None
    node_frag = None
    if gt_skeletons is not None:
        skels = load_skeletons(gt_skeletons, roi=fragments.roi)
        nodes, positions = [], []
        for node, data in skels.nodes(data=True):
            p = Coordinate(*(int(x) for x in data["position"]))
            if fragments.roi.contains(p):
                nodes.append(node)
                positions.append(p)
            else:
                nodes.append(node)
                positions.append(None)
        node_frag = batch_point_lookup(fragments, nodes, positions)

    frags_vox = None
    gt_vox = None
    if gt_labels is not None:
        roi = fragments.roi.intersect(gt_labels.roi)
        frags_vox = fragments.to_ndarray(roi)
        gt_vox = gt_labels.to_ndarray(roi)
        if mask is not None:
            gt_vox = np.where(mask.to_ndarray(roi) > 0, gt_vox, 0)

    def eval_one(t: float):
        comps = native.connected_components_edges(
            len(node_ids), du, dv, scores, t
        )
        lut_new = node_ids[comps.astype(np.int64)]
        entry: Dict = {}
        if skels is not None:
            ids = {
                node: (
                    int(lut_new[dense[f]]) if f in dense and f != 0 else 0
                )
                for node, f in node_frag.items()
            }
            entry["skeletons"] = expected_run_length(skels, ids)
            entry["edits"] = compute_edits(
                _skeleton_components(skels),
                node_frag,
                ids,
                node_ids,
                lut_new,
                eu,
                ev,
                scores,
                float(t),
            )
        if frags_vox is not None:
            seg = native.replace_values(frags_vox, node_ids, lut_new)
            voi = rand_voi(gt_vox, seg)
            voi["voi_sum"] = voi["voi_split"] + voi["voi_merge"]
            voi["nvi_sum"] = voi["nvi_split"] + voi["nvi_merge"]
            entry["voi"] = voi
        return float(t), entry

    # per-threshold work is native C (ctypes releases the GIL) + numpy:
    # a thread pool parallelises thresholds on multi-core hosts (the
    # reference used an mp spawn pool, evaluate_thresholds.py:185-192)
    if num_workers > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=num_workers) as pool:
            results = dict(pool.map(eval_one, thresholds))
    else:
        results = dict(eval_one(t) for t in thresholds)

    summary: Dict = {"thresholds": results}
    if gt_labels is not None:
        best_voi = min(
            results, key=lambda t: results[t]["voi"]["voi_sum"]
        )
        summary["best_voi"] = {
            "threshold": best_voi, **results[best_voi]["voi"]
        }
    if skels is not None:
        best_nerl = max(
            results, key=lambda t: results[t]["skeletons"]["nerl"]
        )
        summary["best_nerl"] = {
            "threshold": best_nerl,
            **results[best_nerl]["skeletons"],
        }
        best_edits = min(
            results,
            key=lambda t: results[t]["edits"]["splits_needed"]
            + results[t]["edits"]["merges_needed"],
        )
        summary["best_edits"] = {
            "threshold": best_edits, **results[best_edits]["edits"]
        }
    return summary
