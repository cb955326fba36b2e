"""Blockwise segmentation pipelines over whole volumes.

The 4-stage hierarchical-agglomeration pipeline (reference
``bootstrapper/post/blockwise/hglom/{frags,agglom,luts,extract}.py``)
and the mutex-watershed pipeline (reference
``bootstrapper/post/blockwise/mutex/*`` via volara), rebuilt on our
blockwise engine + native cores:

1. **fragments** — per block: watershed (or mutex watershed) on the
   block's affinities (+context), mean-affinity fragment filtering,
   crop to the write ROI, id-bump by ``block_id * voxels_per_block``
   (globally unique ids without coordination, ``frags.py:195-198``),
   write fragments Zarr + RAG node centers.
2. **agglomerate** — per block (+context, red-black waves): native
   hierarchical agglomeration to merge-score edges; cross-block edges
   land in the shared RAG (``agglom.py:108-152`` capability).
   For the mutex pipeline this stage scores cross-fragment edges by
   mean affinity per offset sign instead (AffAgglom capability).
3. **luts** — global: read the RAG, threshold sweep -> union-find
   components -> ``fragment_segment_lut`` npz per threshold
   (``luts.py:18-160``); the mutex variant runs one global mutex
   watershed with biased weights (GraphMWS capability).
4. **extract** — per block: LUT gather -> segmentation Zarr
   (``extract.py:19-33``).

A copy of the JAX package's ``post/blockwise_seg.py``.  What differs:
``extract_fragments_blockwise`` and the three pipelines take a
``device``, on which ws computes each block's seeds (the seed kernel,
one launch per block, on ``cuda`` unless ``"cpu"`` is asked for), and
sharded workers run this module of ``bootstrapper_torch`` with that
device.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Optional, Sequence

import numpy as np

from .. import native, resolve_device
from ..core.arrays import Array, open_ds, prepare_ds
from ..core.blockwise import BlockwiseTask, open_ledger, run_blockwise_or_raise
from ..core.geometry import Coordinate, Roi
from .rag import RagDB, open_rag

# .fragments (scipy.ndimage, ~4 s on a slow host) is imported inside the
# frags stage only — LUT/extract/agglomerate subprocess workers skip it.

logger = logging.getLogger(__name__)


def _filter_fragments_by_affinity(fragments, affs, threshold):
    """Zero out fragments whose mean boundary-interior affinity is below
    ``threshold`` (``frags.py:102-117`` capability)."""
    if threshold <= 0:
        return fragments
    mean_affs = np.mean(affs[:3], axis=0)
    ids, inverse = np.unique(fragments, return_inverse=True)
    sums = np.zeros(len(ids))
    counts = np.zeros(len(ids))
    np.add.at(sums, inverse.ravel(), mean_affs.ravel())
    np.add.at(counts, inverse.ravel(), 1)
    means = sums / np.maximum(counts, 1)
    kill = ids[(means < threshold) & (ids != 0)]
    if len(kill):
        fragments = native.replace_values(
            fragments, kill, np.zeros(len(kill), np.uint64)
        )
    return fragments


def extract_fragments_blockwise(
    affs: Array,
    fragments: Array,
    rag: RagDB,
    block_shape: Sequence[int],
    context_voxels: Sequence[int] = (2, 20, 20),
    method: str = "ws",
    fragments_in_xy: bool = True,
    min_seed_distance: int = 10,
    cc_threshold: float = 0.5,
    filter_fragments: float = 0.05,
    epsilon_agglomerate: float = 0.0,
    replace_sections: Optional[Sequence[int]] = None,
    mws_kwargs: Optional[dict] = None,
    num_workers: int = 8,
    roi: Optional[Roi] = None,
    audit: bool = False,
    block_stride: int = 1,
    block_offset: int = 0,
    ledger: Optional[str] = None,
    task_name: str = "extract_fragments",
    device=None,
):
    # ws seeds each block on ``device``: resolved once, here, so a missing
    # card raises before the first block and not as five retries of each
    dev = resolve_device(device) if method == "ws" else None
    vs = affs.voxel_size
    total = roi or fragments.roi
    block_size = Coordinate(block_shape) * vs
    context = Coordinate(context_voxels) * vs
    voxels_per_block = int(np.prod(block_shape))

    def process(block):
        from .fragments import (
            cc_from_affinities,
            mutex_watershed_from_affinities,
            watershed_from_affinities,
        )

        read = block.read_roi
        a = affs.to_ndarray(read).astype(np.float32)
        if np.issubdtype(affs.dtype, np.integer):
            # dtype-keyed, not per-block max: a near-background uint8
            # block (max 1 = p~0.004) must not be misread as normalized
            a = a / 255.0
        if method == "ws":
            # direct-neighbour channels only (reference watershed.py:69)
            a = a[:3]
            frags, _ = watershed_from_affinities(
                a,
                fragments_in_xy=fragments_in_xy,
                min_seed_distance=min_seed_distance,
                device=dev,
            )
        elif method == "mws":
            frags = mutex_watershed_from_affinities(
                a, seed=block.block_id, **(mws_kwargs or {})
            )
        elif method == "cc":
            # per-block connected components over hard direct-neighbour
            # affinities; cross-block hard links are restored by
            # cc_edges_blockwise + the union-find LUT stage.
            # A processed-ROI boundary must behave like a volume
            # boundary (in-memory parity on the same ROI): clear
            # affinities outside ``total`` entirely, and clear channel c
            # at the first in-ROI slice (those values encode edges to
            # phantom/out-of-ROI *previous* voxels that the in-memory
            # path drops).
            lo = [
                max(0, int((total.begin[d] - read.begin[d]) / vs[d]))
                for d in range(3)
            ]
            hi = [
                min(
                    a.shape[1 + d],
                    int((total.end[d] - read.begin[d]) / vs[d]),
                )
                for d in range(3)
            ]
            inside = np.zeros(a.shape[1:], bool)
            inside[tuple(slice(l, h) for l, h in zip(lo, hi))] = True
            a = np.where(inside[None], a, 0.0)
            for c in range(3):
                if read.begin[c] < total.begin[c]:
                    sl = [slice(None)] * 3
                    sl[c] = slice(lo[c], lo[c] + 1)
                    a[c][tuple(sl)] = 0
            frags = cc_from_affinities(a, threshold=cc_threshold)
        else:
            raise ValueError(method)
        frags = _filter_fragments_by_affinity(frags, a, filter_fragments)

        if epsilon_agglomerate > 0:
            # pre-merge fragments up to a small threshold (reference
            # frags.py:120-142): apply merges from the mean-scoring
            # hierarchy below epsilon
            _, _, _, merges = native.agglomerate(
                frags, a[:3], threshold=epsilon_agglomerate,
                merge_function="mean",
            )
            if len(merges):
                # resolve merge chains transitively (b -> a where a may
                # itself merge later)
                parent: dict = {}

                def find(x):
                    while x in parent:
                        x = parent[x]
                    return x

                for ma, mb, _s in merges:
                    parent[int(mb)] = find(int(ma))
                olds = np.array(list(parent), np.uint64)
                news = np.array([find(int(o)) for o in olds], np.uint64)
                frags = native.replace_values(frags, olds, news)

        if replace_sections:
            # zero fragments in globally-indexed defective z-sections
            # (reference frags.py:145-167)
            z0 = int((read.begin[0] - affs.roi.begin[0]) / vs[0])
            for local_z in range(frags.shape[0]):
                if z0 + local_z in replace_sections:
                    frags[local_z] = 0

        # crop to write roi
        wroi = block.write_roi.intersect(total)
        lo = (wroi.begin - read.begin) / vs
        hi = lo + wroi.shape / vs
        core = tuple(slice(int(a_), int(b_)) for a_, b_ in zip(lo, hi))
        frags = np.ascontiguousarray(frags[core])

        # relabel to dense ids then bump by block id for global uniqueness
        ids = np.unique(frags)
        ids = ids[ids != 0]
        if len(ids):
            dense = np.arange(1, len(ids) + 1, dtype=np.uint64)
            bump = np.uint64(block.block_id * voxels_per_block)
            frags = native.replace_values(frags, ids, dense + bump)
            new_ids = dense + bump
            # centers in world units -> RAG nodes (vectorised bincount
            # means: no per-fragment Python loop in this hot stage)
            flat = frags.ravel()
            mask = flat != 0
            idx = (flat[mask] - bump - np.uint64(1)).astype(np.int64)
            counts = np.bincount(idx, minlength=len(new_ids)).astype(
                np.float64
            )
            counts = np.maximum(counts, 1)
            centers = np.empty((len(new_ids), 3))
            grid = np.indices(frags.shape).reshape(3, -1)
            for d in range(3):
                sums = np.bincount(
                    idx,
                    weights=grid[d][mask],
                    minlength=len(new_ids),
                )
                centers[:, d] = wroi.begin[d] + (sums / counts) * vs[d]
            rag.write_nodes(new_ids.tolist(), centers)
        fragments[wroi] = frags

    task = BlockwiseTask(
        name=task_name,
        total_roi=total,
        write_size=block_size,
        context_neg=context,
        context_pos=context,
        process=process,
        fit="shrink",
        read_write_conflict=False,
        num_workers=num_workers,
        audit=audit,
        block_stride=block_stride,
        block_offset=block_offset,
        ledger=ledger,
    )
    return run_blockwise_or_raise(task)


def agglomerate_blockwise(
    affs: Array,
    fragments: Array,
    rag: RagDB,
    block_shape: Sequence[int],
    context_voxels: Sequence[int] = (2, 20, 20),
    merge_function: str = "mean",
    num_workers: int = 8,
    roi: Optional[Roi] = None,
    block_stride: int = 1,
    block_offset: int = 0,
    ledger: Optional[str] = None,
    task_name: str = "agglomerate",
):
    vs = affs.voxel_size
    total = roi or fragments.roi
    block_size = Coordinate(block_shape) * vs
    context = Coordinate(context_voxels) * vs

    def process(block):
        read = block.read_roi.intersect(total)
        frags = fragments.to_ndarray(read)
        if not frags.any():
            return "skipped"
        a = affs.to_ndarray(read)[:3].astype(np.float32)
        if np.issubdtype(affs.dtype, np.integer):
            a = a / 255.0
        eu, ev, es, _ = native.agglomerate(
            frags, a, threshold=1.0, merge_function=merge_function
        )
        if len(eu):
            # unmerged sentinel 2.0 edges stay (never merge) — keep them
            # so the LUT stage knows adjacency but scores them high
            rag.write_edges(eu.tolist(), ev.tolist(), es.tolist())

    task = BlockwiseTask(
        name=task_name,
        total_roi=total,
        write_size=block_size,
        context_neg=context,
        context_pos=context,
        process=process,
        fit="shrink",
        read_write_conflict=True,
        num_workers=num_workers,
        block_stride=block_stride,
        block_offset=block_offset,
        ledger=ledger,
    )
    return run_blockwise_or_raise(task)


def find_segments(
    rag: RagDB,
    lut_dir: str,
    thresholds: Sequence[float],
) -> Dict[float, str]:
    """Global LUTs: union-find components per threshold ->
    fragment_segment_lut npz (``luts.py:18-160`` capability)."""
    os.makedirs(lut_dir, exist_ok=True)
    node_ids, _ = rag.read_nodes()
    eu, ev, scores = rag.read_edges()
    # vectorised id -> dense index (see global_mutex_segments). Edges
    # whose endpoint is missing from the node table (e.g. a partially
    # written RAG from a crashed run) must be masked out: an unguarded
    # searchsorted maps a missing id to its insertion-point NEIGHBOUR —
    # a different fragment — silently merging the wrong fragments (or
    # indexing past the end for ids above max(node_ids)).
    order = np.argsort(node_ids)
    sorted_ids = node_ids[order]
    pu = np.searchsorted(sorted_ids, eu)
    pv = np.searchsorted(sorted_ids, ev)
    keep = (pu < len(sorted_ids)) & (pv < len(sorted_ids))
    keep &= sorted_ids[np.minimum(pu, len(sorted_ids) - 1)] == eu
    keep &= sorted_ids[np.minimum(pv, len(sorted_ids) - 1)] == ev
    if not keep.all():
        logger.warning(
            "find_segments: dropping %d/%d edges with endpoints missing "
            "from the node table (partially written RAG?)",
            int((~keep).sum()), len(keep),
        )
        eu, ev, scores = eu[keep], ev[keep], scores[keep]
        pu, pv = pu[keep], pv[keep]
    du = order[pu].astype(np.uint64)
    dv = order[pv].astype(np.uint64)
    paths = {}
    for t in thresholds:
        comps = native.connected_components_edges(
            len(node_ids), du, dv, scores, t
        )
        segments = node_ids[comps.astype(np.int64)]
        path = os.path.join(
            lut_dir, f"seg_frags2local_{_fmt_threshold(t)}.npz"
        )
        np.savez_compressed(
            path, fragment_segment_lut=np.stack([node_ids, segments])
        )
        paths[t] = path
    return paths


def fragment_pair_means(
    frags: np.ndarray,
    affs: np.ndarray,
    neighborhood: Sequence[Sequence[int]],
) -> Dict[str, tuple]:
    """Mean affinity per touching fragment pair, split into the two
    mutex edge populations (volara AffAgglom capability,
    ``post/blockwise/mutex/*``): ``adj`` = direct-neighbour offsets
    (max |o| <= 1, attractive in the mutex graph) and ``lr`` =
    long-range offsets (repulsive).

    Edge convention matches the in-memory mutex watershed
    (``post/fragments.py``): channel ``c`` at source voxel ``u``
    carries the affinity of edge ``(u, u + neighborhood[c])``.
    Returns ``{group: (us, vs, means)}`` with canonical ``u < v``
    pairs; pairs involving background (0) are dropped.
    """
    shape = frags.shape
    pair_dtype = np.dtype([("u", np.uint64), ("v", np.uint64)])

    def unique_pairs(a, b):
        # structured-view unique: lexsorts the (u,v) records directly —
        # much faster than np.unique(axis=0)'s generic path on the
        # multi-million-pair blocks of a CREMI-scale volume
        rec = np.empty(len(a), pair_dtype)
        rec["u"], rec["v"] = a, b
        uniq, inv = np.unique(rec, return_inverse=True)
        return uniq, inv

    acc: Dict[str, list] = {"adj": [], "lr": []}
    for ci, off in enumerate(neighborhood):
        group = "lr" if max(abs(int(o)) for o in off) > 1 else "adj"
        if any(abs(int(o)) >= s for o, s in zip(off, shape)):
            # offset longer than the block extent (shrunken edge block):
            # no in-bounds pairs, and the negative-stop slice arithmetic
            # below would produce mismatched src/dst shapes
            continue
        src = tuple(
            slice(max(0, -int(o)), s - max(0, int(o)))
            for o, s in zip(off, shape)
        )
        dst = tuple(
            slice(max(0, int(o)), s - max(0, -int(o)))
            for o, s in zip(off, shape)
        )
        u = frags[src].ravel()
        v = frags[dst].ravel()
        w = affs[ci][src].ravel().astype(np.float64)
        m = (u > 0) & (v > 0) & (u != v)
        if not m.any():
            continue
        u, v, w = u[m], v[m], w[m]
        uniq, inv = unique_pairs(np.minimum(u, v), np.maximum(u, v))
        sums = np.bincount(inv, weights=w, minlength=len(uniq))
        counts = np.bincount(inv, minlength=len(uniq))
        acc[group].append((uniq, sums, counts))
    out: Dict[str, tuple] = {}
    for group, parts in acc.items():
        if not parts:
            out[group] = (
                np.zeros(0, np.uint64), np.zeros(0, np.uint64),
                np.zeros(0, np.float64),
            )
            continue
        allp = np.concatenate([p[0] for p in parts])
        alls = np.concatenate([p[1] for p in parts])
        allc = np.concatenate([p[2] for p in parts])
        uniq, inv = np.unique(allp, return_inverse=True)
        sums = np.bincount(inv, weights=alls, minlength=len(uniq))
        counts = np.bincount(inv, weights=allc, minlength=len(uniq))
        out[group] = (
            uniq["u"].astype(np.uint64),
            uniq["v"].astype(np.uint64),
            sums / np.maximum(counts, 1),
        )
    return out


def mws_agglomerate_blockwise(
    affs: Array,
    fragments: Array,
    rag_adj: RagDB,
    rag_lr: RagDB,
    neighborhood: Sequence[Sequence[int]],
    block_shape: Sequence[int],
    context_voxels: Sequence[int] = (2, 20, 20),
    num_workers: int = 8,
    roi: Optional[Roi] = None,
    block_stride: int = 1,
    block_offset: int = 0,
    ledger: Optional[str] = None,
    task_name: str = "agglomerate_mws",
):
    """AffAgglom capability: per block, mean affinity per fragment pair
    for the attractive (adjacent) and repulsive (long-range) offset
    groups, written to two RAG edge tables. The stored score IS the
    mean affinity (higher = stronger attraction/repulsion evidence);
    cross-block duplicates keep the minimum (conservative against
    over-merge for adj, most-repulsive for lr)."""
    vs = affs.voxel_size
    total = roi or fragments.roi
    block_size = Coordinate(block_shape) * vs
    context = Coordinate(context_voxels) * vs

    def process(block):
        read = block.read_roi.intersect(total)
        frags = fragments.to_ndarray(read)
        if not frags.any():
            return "skipped"
        a = affs.to_ndarray(read).astype(np.float32)
        if np.issubdtype(affs.dtype, np.integer):
            a = a / 255.0
        groups = fragment_pair_means(frags, a, neighborhood)
        for rag, key in ((rag_adj, "adj"), (rag_lr, "lr")):
            us, vs_, means = groups[key]
            if len(us):
                rag.write_edges(us.tolist(), vs_.tolist(), means.tolist())

    task = BlockwiseTask(
        name=task_name,
        total_roi=total,
        write_size=block_size,
        context_neg=context,
        context_pos=context,
        process=process,
        fit="shrink",
        read_write_conflict=True,
        num_workers=num_workers,
        block_stride=block_stride,
        block_offset=block_offset,
        ledger=ledger,
    )
    return run_blockwise_or_raise(task)


def global_mutex_segments(
    rag_adj: RagDB,
    lut_dir: str,
    rag_lr: Optional[RagDB] = None,
    adj_bias: float = -0.4,
    lr_bias: float = -0.7,
    bias_pairs: Optional[Sequence[Sequence[float]]] = None,
) -> Dict[str, str]:
    """GraphMWS capability (``mutex/luts.py:17-90``): one global mutex
    watershed over BOTH RAG edge populations with global biases —
    adjacent edges weighted ``mean_adj_aff + adj_bias`` (positive =
    merge) and long-range edges ``mean_lr_aff + lr_bias`` (typically
    negative = mutex constraint), mirroring the voxel-level mutex
    watershed's signed-weight semantics at the fragment level.

    The round-3 scale run exposed why both populations are required:
    scoring only mean short-range affinity centred at 0.5 makes every
    soft boundary (mean aff > 0.5, typical of refiner-chain outputs)
    globally attractive with nothing to stop it — voi_merge 15.7 on a
    125x1250x1250 volume whose in-memory mws measures ~1.2.

    ``bias_pairs`` sweeps several (adj_bias, lr_bias) operating points
    over the SAME RAG (nodes/edges read once) — the mws analog of the
    hierarchical path's threshold sweep, since VOI is very sensitive to
    the global operating point.  Returns one LUT path per pair keyed
    ``mws--a{adj}_l{lr}``; without it, the single (adj_bias, lr_bias)
    point keyed ``mws``.
    """
    os.makedirs(lut_dir, exist_ok=True)
    node_ids, _ = rag_adj.read_nodes()
    order = np.argsort(node_ids)
    sorted_ids = node_ids[order]

    def dense_edges(rag):
        # vectorised id -> dense index: CREMI-scale RAGs carry millions
        # of edges, far too many for per-edge dict lookups on slow hosts
        eu, ev, means = rag.read_edges()
        pu = np.searchsorted(sorted_ids, eu)
        pv = np.searchsorted(sorted_ids, ev)
        keep = (
            (pu < len(sorted_ids)) & (pv < len(sorted_ids))
        )
        keep &= (sorted_ids[np.minimum(pu, len(sorted_ids) - 1)] == eu)
        keep &= (sorted_ids[np.minimum(pv, len(sorted_ids) - 1)] == ev)
        du = order[pu[keep]].astype(np.uint64)
        dv = order[pv[keep]].astype(np.uint64)
        return du, dv, np.asarray(means, np.float64)[keep]

    du_a, dv_a, m_a = dense_edges(rag_adj)
    if rag_lr is not None:
        du_l, dv_l, m_l = dense_edges(rag_lr)
        du = np.concatenate([du_a, du_l])
        dv = np.concatenate([dv_a, dv_l])
    else:  # no long-range population recorded (e.g. 3-offset nets)
        du, dv = du_a, dv_a

    out = {}
    sweep = bias_pairs if bias_pairs is not None else [(adj_bias, lr_bias)]
    for adj_b, lr_b in sweep:
        weights = m_a + adj_b
        if rag_lr is not None:
            weights = np.concatenate([weights, m_l + lr_b])
        labels = native.mutex_watershed_edges(len(node_ids), du, dv, weights)
        segments = node_ids[labels.astype(np.int64)]
        key = (
            mws_sweep_label(adj_b, lr_b) if bias_pairs is not None
            else "mws"
        )
        path = os.path.join(lut_dir, f"seg_frags2local_{key}.npz")
        np.savez_compressed(
            path, fragment_segment_lut=np.stack([node_ids, segments])
        )
        out[key] = path
    return out


def mws_sweep_label(adj_bias: float, lr_bias: float) -> str:
    """Dataset/LUT label for one global-bias operating point."""
    return f"mws--a{adj_bias:g}_l{lr_bias:g}"


def cc_edges_blockwise(
    affs: Array,
    fragments: Array,
    rag: RagDB,
    block_shape: Sequence[int],
    context_voxels: Sequence[int] = (1, 1, 1),
    threshold: float = 0.5,
    num_workers: int = 8,
    roi: Optional[Roi] = None,
    block_stride: int = 1,
    block_offset: int = 0,
    ledger: Optional[str] = None,
    task_name: str = "cc_edges",
):
    """RAG edges for blockwise connected components: one score-0 edge per
    hard-linked fragment pair (affinity channel c at voxel v encodes the
    edge (v, v - e_c), the cc_from_affinities convention).  find_segments
    at any threshold >= 0 then unions exactly the pairs the in-memory CC
    would — the partition matches ``cc_segmentation`` bit for bit.

    The reference declares blockwise cc unimplemented
    (``post/connected_components.py:8-9``); this is a beyond-reference
    capability built from the existing hglom stages."""
    vs = affs.voxel_size
    total = roi or fragments.roi
    block_size = Coordinate(block_shape) * vs
    context = Coordinate(context_voxels) * vs

    def process(block):
        read = block.read_roi.intersect(total)
        frags = fragments.to_ndarray(read)
        if not frags.any():
            return "skipped"
        a = affs.to_ndarray(read)[:3].astype(np.float32)
        if np.issubdtype(affs.dtype, np.integer):
            a = a / 255.0
        pairs = []
        for c in range(3):
            hard = a[c] > threshold
            sl_hi = [slice(None)] * 3
            sl_lo = [slice(None)] * 3
            sl_hi[c] = slice(1, None)
            sl_lo[c] = slice(None, -1)
            m = hard[tuple(sl_hi)]
            u = frags[tuple(sl_lo)][m]
            v = frags[tuple(sl_hi)][m]
            keep = (u != v) & (u != 0) & (v != 0)
            if keep.any():
                pairs.append(np.stack([u[keep], v[keep]], axis=1))
        if not pairs:
            return "skipped"
        uv = np.concatenate(pairs)
        uv.sort(axis=1)  # normalise (u < v) before dedup
        uv = np.unique(uv, axis=0)
        rag.write_edges(
            uv[:, 0].tolist(), uv[:, 1].tolist(), [0.0] * len(uv)
        )

    task = BlockwiseTask(
        name=task_name,
        total_roi=total,
        write_size=block_size,
        context_neg=context,
        context_pos=context,
        process=process,
        fit="shrink",
        # no array writes — only idempotent score-0 RAG upserts — so no
        # red-black serialisation is needed
        read_write_conflict=False,
        num_workers=num_workers,
        block_stride=block_stride,
        block_offset=block_offset,
        ledger=ledger,
    )
    return run_blockwise_or_raise(task)


def cc_pipeline_blockwise(
    affs_path: str,
    output_container: str,
    threshold: float = 0.5,
    remove_debris: int = 0,
    block_shape=(32, 256, 256),
    context_voxels=(2, 32, 32),
    num_workers: int = 8,
    roi: Optional[Roi] = None,
    workers: int = 1,
    block_stride: int = 1,
    block_offset: int = 0,
    ledger: Optional[str] = None,
    db: Optional[dict] = None,
    device=None,
) -> Dict[str, str]:
    """Blockwise thresholded-affinity connected components: cc fragments
    per block -> hard-link RAG edges -> global union-find LUT ->
    relabel.  Output partition equals the in-memory ``cc_segmentation``
    (tests/test_blockwise_seg.py).  ``workers > 1``: crash-isolated
    stride shards, as in the other pipelines."""
    seg_path = (
        f"{output_container}/segmentations_cc/cc-{_fmt_threshold(threshold)}"
    )
    if workers > 1 and block_stride == 1:
        ledger = ledger or f"{output_container}/ledger_cc.db"
        _fresh_ledger(ledger)
        _run_sharded(
            "cc_pipeline_blockwise",
            dict(
                affs_path=affs_path, output_container=output_container,
                threshold=threshold, remove_debris=remove_debris,
                block_shape=list(block_shape),
                context_voxels=list(context_voxels),
                num_workers=num_workers, roi=roi, ledger=ledger, db=db,
            ),
            workers,
            device,
        )
        return {"cc": seg_path}

    sharded = block_stride > 1
    led = open_ledger(ledger) if ledger else None
    affs = open_ds(affs_path)
    total = roi or affs.roi
    vs = affs.voxel_size
    vox_shape = tuple(Coordinate(total.shape) / vs)
    chunk = tuple(min(b, s) for b, s in zip(block_shape, vox_shape))

    frag_path = f"{output_container}/fragments_cc"
    rag_path = f"{output_container}/rag_cc.db"
    db_cfg = (
        {"table_prefix": "rag_cc", **db}
        if db
        else {"db_file": rag_path}
    )
    # Idempotent under crash-respawn of shard 0 (see waterz pipeline).
    setup_done = bool(led) and led.count_done("setup_cc", [0]) > 0
    if (not sharded or block_offset == 0) and not setup_done:
        fragments = prepare_ds(
            frag_path, vox_shape, total.offset, vs, np.uint64,
            chunk_shape=chunk,
        )
        rag = open_rag(db_cfg, mode="w")
        prepare_ds(
            seg_path, vox_shape, total.offset, vs, np.uint64,
            chunk_shape=chunk,
        )
        if led:
            led.mark_done("setup_cc", 0)
    else:
        if led:
            led.wait_for("setup_cc", [0])
        fragments = open_ds(frag_path, mode="r+")
        rag = open_rag(db_cfg, mode="r+")

    extract_fragments_blockwise(
        affs, fragments, rag, block_shape, context_voxels,
        method="cc", cc_threshold=threshold, filter_fragments=0.0,
        num_workers=num_workers, roi=total,
        block_stride=block_stride, block_offset=block_offset,
        ledger=ledger, task_name="extract_fragments_cc", device=device,
    )
    cc_edges_blockwise(
        affs, fragments, rag, block_shape, (1, 1, 1),
        threshold=threshold, num_workers=num_workers, roi=total,
        block_stride=block_stride, block_offset=block_offset,
        ledger=ledger,
    )
    lut_dir = f"{output_container}/luts_cc"
    luts_done = bool(led) and led.count_done("luts_cc", [0]) > 0
    if (not sharded or block_offset == 0) and not luts_done:
        luts = find_segments(rag, lut_dir, [0.5])
        if led:
            led.mark_done("luts_cc", 0)
    else:
        if led:
            led.wait_for("luts_cc", [0])
        luts = {0.5: os.path.join(lut_dir, "seg_frags2local_0_5.npz")}
    seg = open_ds(seg_path, mode="r+")
    extract_segmentation_blockwise(
        fragments, seg, luts[0.5], block_shape, num_workers, roi=total,
        block_stride=block_stride, block_offset=block_offset,
        ledger=ledger,
    )
    if remove_debris:
        # remove_small_segments parity, blockwise: global per-segment
        # voxel counts, then zero ids below the cutoff.  Shard 0 only
        # (needs global sums); idempotent under crash-respawn, so the
        # ledger marker is just a skip for completed re-runs.
        debris_done = bool(led) and led.count_done("debris_cc", [0]) > 0
        if (not sharded or block_offset == 0) and not debris_done:
            import threading

            sizes: dict = {}
            lock = threading.Lock()

            def count_block(block):
                wroi = block.write_roi.intersect(total)
                ids, counts = np.unique(
                    seg.to_ndarray(wroi), return_counts=True
                )
                with lock:
                    for i, c in zip(ids.tolist(), counts.tolist()):
                        if i:
                            sizes[i] = sizes.get(i, 0) + c

            block_size = Coordinate(block_shape) * vs
            run_blockwise_or_raise(BlockwiseTask(
                name="cc_debris_count", total_roi=total,
                write_size=block_size,
                context_neg=Coordinate.zeros(total.dims),
                context_pos=Coordinate.zeros(total.dims),
                process=count_block, num_workers=num_workers,
            ))
            kill = np.array(
                [i for i, c in sizes.items() if c < remove_debris],
                np.uint64,
            )
            if len(kill):
                zeros = np.zeros(len(kill), np.uint64)

                def zero_block(block):
                    wroi = block.write_roi.intersect(total)
                    arr = seg.to_ndarray(wroi)
                    seg[wroi] = native.replace_values(arr, kill, zeros)

                run_blockwise_or_raise(BlockwiseTask(
                    name="cc_debris_zero", total_roi=total,
                    write_size=block_size,
                    context_neg=Coordinate.zeros(total.dims),
                    context_pos=Coordinate.zeros(total.dims),
                    process=zero_block, num_workers=num_workers,
                ))
            if led:
                led.mark_done("debris_cc", 0)
    return {"cc": seg_path}


def extract_segmentation_blockwise(
    fragments: Array,
    segmentation: Array,
    lut_path: str,
    block_shape: Sequence[int],
    num_workers: int = 8,
    roi: Optional[Roi] = None,
    block_stride: int = 1,
    block_offset: int = 0,
    ledger: Optional[str] = None,
    task_name: Optional[str] = None,
):
    lut = np.load(lut_path)["fragment_segment_lut"]
    lut_old, lut_new = lut[0], lut[1]
    vs = fragments.voxel_size
    total = roi or fragments.roi
    block_size = Coordinate(block_shape) * vs

    def process(block):
        wroi = block.write_roi.intersect(total)
        frags = fragments.to_ndarray(wroi)
        if not frags.any():
            return "skipped"
        segmentation[wroi] = native.replace_values(frags, lut_old, lut_new)

    task = BlockwiseTask(
        name=task_name
        or f"extract_segmentation:{os.path.basename(lut_path)}",
        total_roi=total,
        write_size=block_size,
        context_neg=Coordinate.zeros(total.dims),
        context_pos=Coordinate.zeros(total.dims),
        process=process,
        num_workers=num_workers,
        block_stride=block_stride,
        block_offset=block_offset,
        ledger=ledger,
    )
    return run_blockwise_or_raise(task)


def _fmt_threshold(t: float) -> str:
    return f"{t:.3f}".rstrip("0").rstrip(".").replace(".", "_")


def _run_sharded(func_name: str, kwargs: dict, workers: int, device=None):
    """Spawn ``workers`` crash-isolated subprocesses, each running this
    module's ``func_name`` over a stride-shard of the block grid (daisy
    worker-pool analog, reference ``predict.py:27-50``).  Each worker gets
    ``device`` as a string (``None`` stays ``None``, which means ``cuda``),
    so it computes where its caller asked."""
    import json
    import sys

    from ..core.blockwise import run_sharded_subprocesses, worker_env

    kw = dict(kwargs)
    roi = kw.get("roi")
    if roi is not None:
        kw["roi"] = [list(roi.offset), list(roi.shape)]
    kw["device"] = None if device is None else str(device)

    def make_argv(i, n):
        blob = json.dumps({**kw, "block_stride": n, "block_offset": i,
                           "workers": 1})
        code = (
            "import json\n"
            "from bootstrapper_torch.post import blockwise_seg as B\n"
            "from bootstrapper_torch.core.geometry import Roi\n"
            f"kw = json.loads({blob!r})\n"
            "if kw.get('roi'):\n"
            "    kw['roi'] = Roi(*kw['roi'])\n"
            f"B.{func_name}(**kw)\n"
        )
        return [sys.executable, "-c", code]

    run_sharded_subprocesses(make_argv, workers, env=worker_env())


def _fresh_ledger(path: str):
    if path.endswith(("/", ".d")) or os.path.isdir(path):
        import shutil

        shutil.rmtree(path, ignore_errors=True)
        return
    for suffix in ("", "-wal", "-shm"):
        if os.path.exists(path + suffix):
            os.remove(path + suffix)


def waterz_pipeline_blockwise(
    affs_path: str,
    output_container: str,
    block_shape=(32, 256, 256),
    context_voxels=(2, 32, 32),
    thresholds=(0.2, 0.35, 0.5),
    merge_function: str = "mean",
    fragments_in_xy: bool = True,
    min_seed_distance: int = 10,
    filter_fragments: float = 0.05,
    epsilon_agglomerate: float = 0.0,
    replace_sections=None,
    num_workers: int = 8,
    roi: Optional[Roi] = None,
    workers: int = 1,
    block_stride: int = 1,
    block_offset: int = 0,
    ledger: Optional[str] = None,
    db: Optional[dict] = None,
    device=None,
) -> Dict[float, str]:
    """Full 4-stage pipeline; returns {threshold: segmentation path}.

    Dataset naming mirrors the reference's parameter-encoded scheme
    (``watershed.py:127-151``): fragments under ``fragments_ws``, segs
    under ``segmentations_ws/{merge_function}--{threshold}``.

    ``workers > 1`` runs the pipeline in that many crash-isolated
    subprocesses, each working a stride-shard of every block grid and
    synchronising between stages through the completion ledger; the
    LUT stage runs in shard 0 only.  Each block's seeds run on
    ``device`` (``cuda`` unless ``"cpu"`` is asked for), in every worker.
    """
    seg_name = lambda t: (
        f"{output_container}/segmentations_ws/"
        f"{merge_function}--{_fmt_threshold(t)}"
    )
    if workers > 1 and block_stride == 1:
        ledger = ledger or f"{output_container}/ledger_ws.db"
        _fresh_ledger(ledger)
        if resolve_device(device).type == "cuda":
            # build the seed kernel here, once: workers that all found it
            # stale would each run nvcc
            from ..ops import _build

            _build.build_all(("seed_maxima",))
        _run_sharded(
            "waterz_pipeline_blockwise",
            dict(
                affs_path=affs_path, output_container=output_container,
                block_shape=list(block_shape),
                context_voxels=list(context_voxels),
                thresholds=list(thresholds), merge_function=merge_function,
                fragments_in_xy=fragments_in_xy,
                min_seed_distance=min_seed_distance,
                filter_fragments=filter_fragments,
                epsilon_agglomerate=epsilon_agglomerate,
                replace_sections=replace_sections,
                num_workers=num_workers, roi=roi, ledger=ledger,
                db=db,
            ),
            workers,
            device,
        )
        return {t: seg_name(t) for t in thresholds}

    sharded = block_stride > 1
    led = open_ledger(ledger) if ledger else None
    affs = open_ds(affs_path)
    total = roi or affs.roi
    vs = affs.voxel_size
    vox_shape = tuple(Coordinate(total.shape) / vs)
    chunk = tuple(min(b, s) for b, s in zip(block_shape, vox_shape))

    frag_path = f"{output_container}/fragments_ws"
    rag_path = f"{output_container}/rag_ws.db"
    # RAG backend: SQLite file by default; a db config with db_name/
    # db_host routes to PostgreSQL (reference hglom/frags.py:208-233).
    # Per-method table prefix mirrors the per-method SQLite file names
    # so ws/mws/cc in one database never drop each other's RAG.
    db_cfg = (
        {"table_prefix": "rag_ws", **db}
        if db
        else {"db_file": rag_path}
    )
    # Setup must be idempotent under crash-respawn: a respawned shard 0
    # re-enters here after the ledger already recorded setup_ws, and
    # recreating the datasets/RAG (mode="w") would wipe blocks other
    # shards already wrote while the ledger still marks them done.
    setup_done = bool(led) and led.count_done("setup_ws", [0]) > 0
    if (not sharded or block_offset == 0) and not setup_done:
        fragments = prepare_ds(
            frag_path, vox_shape, total.offset, vs, np.uint64,
            chunk_shape=chunk,
        )
        rag = open_rag(db_cfg, mode="w")
        for t in thresholds:
            prepare_ds(
                seg_name(t), vox_shape, total.offset, vs, np.uint64,
                chunk_shape=chunk,
            )
        if led:
            led.mark_done("setup_ws", 0)
    else:
        if led:
            led.wait_for("setup_ws", [0])
        fragments = open_ds(frag_path, mode="r+")
        rag = open_rag(db_cfg, mode="r+")

    extract_fragments_blockwise(
        affs, fragments, rag, block_shape, context_voxels,
        method="ws", fragments_in_xy=fragments_in_xy,
        min_seed_distance=min_seed_distance,
        filter_fragments=filter_fragments,
        epsilon_agglomerate=epsilon_agglomerate,
        replace_sections=replace_sections,
        num_workers=num_workers,
        roi=total,
        block_stride=block_stride, block_offset=block_offset,
        ledger=ledger, task_name="extract_fragments_ws", device=device,
    )
    agglomerate_blockwise(
        affs, fragments, rag, block_shape, context_voxels,
        merge_function=merge_function, num_workers=num_workers, roi=total,
        block_stride=block_stride, block_offset=block_offset,
        ledger=ledger, task_name="agglomerate_ws",
    )
    lut_dir = f"{output_container}/luts_ws"
    luts_done = bool(led) and led.count_done("luts_ws", [0]) > 0
    if (not sharded or block_offset == 0) and not luts_done:
        luts = find_segments(rag, lut_dir, thresholds)
        if led:
            led.mark_done("luts_ws", 0)
    else:
        if led:
            led.wait_for("luts_ws", [0])
        luts = {
            t: os.path.join(
                lut_dir, f"seg_frags2local_{_fmt_threshold(t)}.npz"
            )
            for t in thresholds
        }
    seg_paths = {}
    for t, lut_path in luts.items():
        seg = open_ds(seg_name(t), mode="r+")
        extract_segmentation_blockwise(
            fragments, seg, lut_path, block_shape, num_workers, roi=total,
            block_stride=block_stride, block_offset=block_offset,
            ledger=ledger,
        )
        seg_paths[t] = seg_name(t)
    return seg_paths


def mws_pipeline_blockwise(
    affs_path: str,
    output_container: str,
    neighborhood: Sequence[Sequence[int]],
    bias: Sequence[float],
    block_shape=(32, 256, 256),
    context_voxels=(2, 32, 32),
    filter_fragments: float = 0.1,
    num_workers: int = 8,
    roi: Optional[Roi] = None,
    workers: int = 1,
    block_stride: int = 1,
    block_offset: int = 0,
    ledger: Optional[str] = None,
    db: Optional[dict] = None,
    global_bias_sweep: Optional[Sequence[Sequence[float]]] = None,
    device=None,
    **mws_kwargs,
) -> Dict[str, str]:
    """Blockwise mutex pipeline (volara ExtractFrags/AffAgglom/GraphMWS/
    Relabel capability).  ``workers > 1``: see waterz_pipeline_blockwise.

    ``global_bias_sweep``: (adj_bias, lr_bias) pairs swept over the SAME
    fragments + RAG in the global step — the mws analog of the
    hierarchical path's threshold sweep (fragments and edge scores are
    bias-vector products; the global operating point is cheap to vary,
    and VOI is very sensitive to it).  One segmentation dataset per
    pair; the evaluate stage then picks the best, same as ws thresholds.
    """
    if global_bias_sweep is not None:
        seg_paths = {
            mws_sweep_label(a, l): (
                f"{output_container}/segmentations_mws/"
                f"{mws_sweep_label(a, l)}"
            )
            for a, l in global_bias_sweep
        }
    else:
        seg_paths = {"mws": f"{output_container}/segmentations_mws/mws"}
    if workers > 1 and block_stride == 1:
        ledger = ledger or f"{output_container}/ledger_mws.db"
        _fresh_ledger(ledger)
        _run_sharded(
            "mws_pipeline_blockwise",
            dict(
                affs_path=affs_path, output_container=output_container,
                neighborhood=[list(o) for o in neighborhood],
                bias=list(bias), block_shape=list(block_shape),
                context_voxels=list(context_voxels),
                filter_fragments=filter_fragments,
                num_workers=num_workers, roi=roi, ledger=ledger,
                db=db,
                global_bias_sweep=(
                    [list(p) for p in global_bias_sweep]
                    if global_bias_sweep is not None
                    else None
                ),
                **mws_kwargs,
            ),
            workers,
            device,
        )
        return seg_paths

    sharded = block_stride > 1
    led = open_ledger(ledger) if ledger else None
    affs = open_ds(affs_path)
    total = roi or affs.roi
    vs = affs.voxel_size
    vox_shape = tuple(Coordinate(total.shape) / vs)
    chunk = tuple(min(b, s) for b, s in zip(block_shape, vox_shape))

    frag_path = f"{output_container}/fragments_mws"
    rag_path = f"{output_container}/rag_mws.db"
    lr_rag_path = f"{output_container}/rag_mws_lr.db"
    # the long-range (repulsive) edge population lives in its own
    # table/file so both back-ends keep the simple (u,v,score) schema;
    # its prefix derives from the adjacent one so a user-supplied
    # table_prefix namespaces BOTH populations consistently (open_rag
    # maps prefixes to sibling files for SQLite db_file configs)
    base_prefix = (db or {}).get("table_prefix", "rag_mws")
    db_cfg = (
        {**db, "table_prefix": base_prefix}
        if db
        else {"db_file": rag_path}
    )
    lr_cfg = (
        {**db, "table_prefix": base_prefix + "_lr"}
        if db
        else {"db_file": lr_rag_path}
    )
    # Idempotent under crash-respawn of shard 0 (see waterz pipeline).
    setup_done = bool(led) and led.count_done("setup_mws", [0]) > 0
    if (not sharded or block_offset == 0) and not setup_done:
        fragments = prepare_ds(
            frag_path, vox_shape, total.offset, vs, np.uint64,
            chunk_shape=chunk,
        )
        rag = open_rag(db_cfg, mode="w")
        rag_lr = open_rag(lr_cfg, mode="w")
        for sp in seg_paths.values():
            prepare_ds(
                sp, vox_shape, total.offset, vs, np.uint64,
                chunk_shape=chunk,
            )
        if led:
            led.mark_done("setup_mws", 0)
    else:
        if led:
            led.wait_for("setup_mws", [0])
        fragments = open_ds(frag_path, mode="r+")
        rag = open_rag(db_cfg, mode="r+")
        rag_lr = open_rag(lr_cfg, mode="r+")

    extract_fragments_blockwise(
        affs, fragments, rag, block_shape, context_voxels,
        method="mws",
        filter_fragments=filter_fragments,
        mws_kwargs={"neighborhood": neighborhood, "bias": bias, **mws_kwargs},
        num_workers=num_workers, roi=total,
        block_stride=block_stride, block_offset=block_offset,
        ledger=ledger, task_name="extract_fragments_mws", device=device,
    )
    mws_agglomerate_blockwise(
        affs, fragments, rag, rag_lr, neighborhood,
        block_shape, context_voxels,
        num_workers=num_workers, roi=total,
        block_stride=block_stride, block_offset=block_offset,
        ledger=ledger, task_name="agglomerate_mws",
    )
    # the global graph reuses the voxel-level per-channel biases at the
    # fragment level: one global bias per edge population
    is_lr = [max(abs(int(o)) for o in off) > 1 for off in neighborhood]
    adj_b = [b for b, l in zip(bias, is_lr) if not l]
    lr_b = [b for b, l in zip(bias, is_lr) if l]
    lut_dir = f"{output_container}/luts_mws"
    luts_done = bool(led) and led.count_done("luts_mws", [0]) > 0
    if (not sharded or block_offset == 0) and not luts_done:
        luts = global_mutex_segments(
            rag, lut_dir,
            rag_lr=rag_lr if any(is_lr) else None,
            adj_bias=float(np.mean(adj_b)) if adj_b else -0.4,
            lr_bias=float(np.mean(lr_b)) if lr_b else -0.7,
            bias_pairs=global_bias_sweep,
        )
        if led:
            led.mark_done("luts_mws", 0)
    else:
        if led:
            led.wait_for("luts_mws", [0])
        luts = {
            k: os.path.join(lut_dir, f"seg_frags2local_{k}.npz")
            for k in seg_paths
        }
    for key, sp in seg_paths.items():
        seg = open_ds(sp, mode="r+")
        extract_segmentation_blockwise(
            fragments, seg, luts[key], block_shape, num_workers,
            roi=total, block_stride=block_stride,
            block_offset=block_offset, ledger=ledger,
            task_name=f"extract_seg_{key}",
        )
    return seg_paths
