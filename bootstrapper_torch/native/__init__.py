"""ctypes bindings to the native post-processing core (see src/post.cpp).

The shared library is built on demand with g++ (no pip/pybind needed)
and cached next to the source; rebuilds happen when the source is newer
than the binary.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "src", "post.cpp")
_LIB = os.path.join(_DIR, "build", "libbootstrapper_post.so")
_LOCK = threading.Lock()
_lib = None


def _build():
    # compile to a process-unique temp name + atomic rename: concurrent
    # worker processes may all notice a stale binary at once, and two
    # g++ -o writes interleaving on the same path would corrupt it
    os.makedirs(os.path.dirname(_LIB), exist_ok=True)
    tmp = f"{_LIB}.{os.getpid()}.tmp"
    cmd = [
        "g++", "-O3", "-march=native", "-std=c++17", "-fPIC", "-shared",
        _SRC, "-o", tmp,
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
        os.replace(tmp, _LIB)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def get_lib() -> ctypes.CDLL:
    global _lib
    with _LOCK:
        if _lib is not None:
            return _lib
        if (
            not os.path.exists(_LIB)
            or os.path.getmtime(_LIB) < os.path.getmtime(_SRC)
        ):
            _build()
        lib = ctypes.CDLL(_LIB)

        u64p = ctypes.POINTER(ctypes.c_uint64)
        f32p = ctypes.POINTER(ctypes.c_float)
        f64p = ctypes.POINTER(ctypes.c_double)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i64 = ctypes.c_int64
        u64 = ctypes.c_uint64

        lib.connected_components_edges.argtypes = [
            u64, u64p, u64p, f64p, u64, ctypes.c_double, u64p
        ]
        lib.cc_from_hard_affs.argtypes = [u8p, i64, i64, i64, u64p]
        lib.watershed_seeded.argtypes = [f32p, u64p, u8p, i64, i64, i64]
        lib.mutex_watershed.argtypes = [u64, u64p, u64p, f64p, u64p, u64, u64p]
        lib.agglomerate.argtypes = [
            u64p, f32p, i64, i64, i64, ctypes.c_double,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            u64p, u64p, f64p, i64,
            u64p, u64p, f64p, i64,
            ctypes.POINTER(i64),
        ]
        lib.agglomerate.restype = i64
        lib.replace_values.argtypes = [u64p, u64, u64p, u64p, u64, u64p]
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.mutex_watershed_dense.argtypes = [
            f32p, i64, i64, i64, i32p, u64, f64p, i32p, u8p,
            ctypes.c_double, u64, u64p,
        ]
        lib.mutex_watershed_dense.restype = u64
        u32p = ctypes.POINTER(ctypes.c_uint32)
        lib.contingency_build.argtypes = [
            u64p, u64p, u64, ctypes.c_int, u64p, u64p, u64p, u64p
        ]
        lib.contingency_build.restype = ctypes.c_void_p
        lib.contingency_fetch.argtypes = [
            ctypes.c_void_p, u64p, u64p, u32p, u32p, u64p
        ]
        lib.split_graph_mincut.argtypes = [
            u64, u64, u64p, u64p, f64p, u64, u64p, u64p, u64p
        ]
        lib.split_graph_mincut.restype = i64
        _lib = lib
        return _lib


def _p(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


# ---------------------------------------------------------------------------
# high-level wrappers
# ---------------------------------------------------------------------------


def connected_components_edges(n_nodes, edges_u, edges_v, scores, threshold):
    """Union-find CC over dense nodes [0,n): returns root-representative
    labels (funlib.segment.connected_components capability)."""
    lib = get_lib()
    edges_u = np.ascontiguousarray(edges_u, np.uint64)
    edges_v = np.ascontiguousarray(edges_v, np.uint64)
    scores = np.ascontiguousarray(scores, np.float64)
    out = np.empty(int(n_nodes), np.uint64)
    lib.connected_components_edges(
        ctypes.c_uint64(int(n_nodes)),
        _p(edges_u, ctypes.c_uint64),
        _p(edges_v, ctypes.c_uint64),
        _p(scores, ctypes.c_double),
        ctypes.c_uint64(len(scores)),
        ctypes.c_double(threshold),
        _p(out, ctypes.c_uint64),
    )
    return out


def cc_from_hard_affs(hard_affs):
    """(3,Z,Y,X) bool/0-1 -> (Z,Y,X) uint64 components (numba-CC
    capability, reference ``bootstrapper/post/cc.py:6-74``)."""
    lib = get_lib()
    hard = np.ascontiguousarray(hard_affs, np.uint8)
    assert hard.ndim == 4 and hard.shape[0] == 3
    Z, Y, X = hard.shape[1:]
    out = np.empty((Z, Y, X), np.uint64)
    lib.cc_from_hard_affs(
        _p(hard, ctypes.c_uint8), Z, Y, X, _p(out, ctypes.c_uint64)
    )
    return out


def watershed_seeded(landscape, seeds, mask=None):
    """Priority-flood watershed ascending ``landscape`` from ``seeds``
    (skimage.watershed capability); 0s in ``mask`` stay background."""
    lib = get_lib()
    landscape = np.ascontiguousarray(landscape, np.float32)
    labels = np.ascontiguousarray(seeds, np.uint64).copy()
    if landscape.ndim == 2:
        landscape = landscape[None]
        labels = labels[None]
        mask2 = None if mask is None else np.asarray(mask)[None]
        return watershed_seeded(landscape, labels, mask2)[0]
    Z, Y, X = landscape.shape
    mask_arr = (
        np.ascontiguousarray(mask, np.uint8)
        if mask is not None
        else np.ones((Z, Y, X), np.uint8)
    )
    lib.watershed_seeded(
        _p(landscape, ctypes.c_float),
        _p(labels, ctypes.c_uint64),
        _p(mask_arr, ctypes.c_uint8),
        Z, Y, X,
    )
    return labels


def mutex_watershed_edges(n_nodes, edges_u, edges_v, weights):
    """Mutex watershed over a signed-weight edge list (mwatershed
    capability): positive weights attract, negative repel; processed by
    descending |weight|. Returns root labels per node."""
    lib = get_lib()
    edges_u = np.ascontiguousarray(edges_u, np.uint64)
    edges_v = np.ascontiguousarray(edges_v, np.uint64)
    weights = np.ascontiguousarray(weights, np.float64)
    order = np.argsort(-np.abs(weights), kind="stable").astype(np.uint64)
    out = np.empty(int(n_nodes), np.uint64)
    lib.mutex_watershed(
        ctypes.c_uint64(int(n_nodes)),
        _p(edges_u, ctypes.c_uint64),
        _p(edges_v, ctypes.c_uint64),
        _p(weights, ctypes.c_double),
        _p(order, ctypes.c_uint64),
        ctypes.c_uint64(len(weights)),
        _p(out, ctypes.c_uint64),
    )
    return out


def mutex_watershed_dense(
    affs, neighborhood, bias, strides, randomized, noise_eps=0.0, seed=0
):
    """Mutex watershed straight from the affinity grid: native edge
    generation, per-channel bias + counter-based gaussian noise, stable
    radix sort by |weight|, clustering, and 1..K densification in one
    C++ pass (10x the edge-list path on hosts where the numpy index
    math dominates).  Returns (labels (Z,Y,X) uint64, n_fragments)."""
    lib = get_lib()
    affs = np.ascontiguousarray(affs, np.float32)
    C, (Z, Y, X) = affs.shape[0], affs.shape[1:]
    if C >= 128:
        raise ValueError("mutex_watershed_dense supports < 128 channels")
    if Z * Y * X >= 2**32:
        raise ValueError("volume too large for 32-bit edge indices")
    nb = np.ascontiguousarray(neighborhood, np.int32)
    st = np.ascontiguousarray(strides, np.int32)
    rd = np.ascontiguousarray(randomized, np.uint8)
    bs = np.ascontiguousarray(bias, np.float64)
    assert nb.shape == (C, 3) and st.shape == (C, 3)
    assert rd.shape == (C,) and bs.shape == (C,)
    out = np.empty(Z * Y * X, np.uint64)
    k = lib.mutex_watershed_dense(
        _p(affs, ctypes.c_float),
        ctypes.c_int64(Z), ctypes.c_int64(Y), ctypes.c_int64(X),
        _p(nb, ctypes.c_int32),
        ctypes.c_uint64(C),
        _p(bs, ctypes.c_double),
        _p(st, ctypes.c_int32),
        _p(rd, ctypes.c_uint8),
        ctypes.c_double(float(noise_eps)),
        ctypes.c_uint64(int(seed)),
        _p(out, ctypes.c_uint64),
    )
    if int(k) == 2**64 - 1:  # native sentinel: edge count >= 2^32
        raise ValueError(
            "mutex_watershed_dense: total edge count exceeds 32-bit "
            "indices (too many voxels x offsets); tile the volume"
        )
    return out.reshape(Z, Y, X), int(k)


def agglomerate(
    fragments,
    affs,
    threshold=1.0,
    merge_function="mean",
):
    """Hierarchical RAG agglomeration (waterz capability).

    fragments: (Z,Y,X) uint64; affs: (3,Z,Y,X) float32 in [0,1]
    (direct z/y/x neighbour affinities).
    Returns (edges_u, edges_v, edge_merge_scores, merges) where
    edge_merge_scores[i] is the threshold at which edge i's endpoints
    merged (2.0 if never), and merges is an (M,3) float array of
    (id_a, id_b, score) history.
    """
    lib = get_lib()
    fragments = np.ascontiguousarray(fragments, np.uint64)
    affs = np.ascontiguousarray(affs, np.float32)
    Z, Y, X = fragments.shape
    mode, quant, initmax = _parse_merge_function(merge_function)

    edge_cap = max(1024, int(fragments.size))
    merge_cap = edge_cap
    while True:
        eu = np.empty(edge_cap, np.uint64)
        ev = np.empty(edge_cap, np.uint64)
        es = np.empty(edge_cap, np.float64)
        ma = np.empty(merge_cap, np.uint64)
        mb = np.empty(merge_cap, np.uint64)
        ms = np.empty(merge_cap, np.float64)
        n_merges = ctypes.c_int64(0)
        n_edges = lib.agglomerate(
            _p(fragments, ctypes.c_uint64),
            _p(affs, ctypes.c_float),
            Z, Y, X,
            ctypes.c_double(threshold),
            mode, quant, initmax,
            _p(eu, ctypes.c_uint64), _p(ev, ctypes.c_uint64),
            _p(es, ctypes.c_double), edge_cap,
            _p(ma, ctypes.c_uint64), _p(mb, ctypes.c_uint64),
            _p(ms, ctypes.c_double), merge_cap,
            ctypes.byref(n_merges),
        )
        if n_edges >= 0:
            m = n_merges.value
            return (
                eu[:n_edges], ev[:n_edges], es[:n_edges],
                np.stack(
                    [ma[:m].astype(np.float64),
                     mb[:m].astype(np.float64),
                     ms[:m]], axis=1
                ),
            )
        edge_cap *= 2
        merge_cap *= 2


def _parse_merge_function(name: str):
    """'mean' | 'hist_quant_<q>[_initmax]' -> (mode, quantile, initmax)
    (the reference's merge-function names,
    ``post/blockwise/hglom/agglom.py:206-215``)."""
    if name == "mean":
        return 0, 0, 0
    if name.startswith("hist_quant_"):
        rest = name[len("hist_quant_"):]
        initmax = 1 if rest.endswith("_initmax") else 0
        q = int(rest.replace("_initmax", ""))
        return 1, q, initmax
    raise ValueError(f"unknown merge function {name!r}")


def pair_contingency(gt, seg, ignore_gt_zero=True):
    """Sparse contingency table of two uint64 label arrays in one O(n)
    hashing pass (funlib.evaluate rand_voi capability — the reference
    outsources this hot loop to funlib's C++ too).

    Returns ``(gt_ids, seg_ids, pair_gi, pair_sj, pair_counts, kept)``:
    distinct ids in first-seen order, dense pair indices into them,
    per-pair voxel counts, and the number of voxels counted (after the
    gt==0 skip)."""
    lib = get_lib()
    gt = np.ascontiguousarray(np.asarray(gt).reshape(-1), np.uint64)
    seg = np.ascontiguousarray(np.asarray(seg).reshape(-1), np.uint64)
    if gt.size != seg.size:
        raise ValueError(f"shape mismatch: {gt.size} vs {seg.size}")
    n_pairs = ctypes.c_uint64()
    n_gt = ctypes.c_uint64()
    n_seg = ctypes.c_uint64()
    kept = ctypes.c_uint64()
    handle = lib.contingency_build(
        _p(gt, ctypes.c_uint64), _p(seg, ctypes.c_uint64),
        ctypes.c_uint64(gt.size), ctypes.c_int(1 if ignore_gt_zero else 0),
        ctypes.byref(n_pairs), ctypes.byref(n_gt), ctypes.byref(n_seg),
        ctypes.byref(kept),
    )
    gt_ids = np.empty(n_gt.value, np.uint64)
    seg_ids = np.empty(n_seg.value, np.uint64)
    pair_gi = np.empty(n_pairs.value, np.uint32)
    pair_sj = np.empty(n_pairs.value, np.uint32)
    pair_counts = np.empty(n_pairs.value, np.uint64)
    lib.contingency_fetch(
        handle,
        _p(gt_ids, ctypes.c_uint64), _p(seg_ids, ctypes.c_uint64),
        _p(pair_gi, ctypes.c_uint32), _p(pair_sj, ctypes.c_uint32),
        _p(pair_counts, ctypes.c_uint64),
    )
    return gt_ids, seg_ids, pair_gi, pair_sj, pair_counts, int(kept.value)


def replace_values(arr, lut_old, lut_new):
    """Bulk id relabel via sorted LUT (funlib.segment.replace_values
    capability); ids missing from the LUT map to themselves."""
    lib = get_lib()
    arr = np.ascontiguousarray(arr, np.uint64)
    order = np.argsort(lut_old)
    lut_old = np.ascontiguousarray(np.asarray(lut_old, np.uint64)[order])
    lut_new = np.ascontiguousarray(np.asarray(lut_new, np.uint64)[order])
    out = np.empty_like(arr)
    lib.replace_values(
        _p(arr, ctypes.c_uint64), ctypes.c_uint64(arr.size),
        _p(lut_old, ctypes.c_uint64), _p(lut_new, ctypes.c_uint64),
        ctypes.c_uint64(len(lut_old)),
        _p(out.reshape(-1), ctypes.c_uint64),
    )
    return out.reshape(arr.shape)


def split_graph_mincut(n_nodes, edges_u, edges_v, capacities, components):
    """Separate seed-node sets by recursive Dinic min-cuts (the
    ``eval/mincut.py split_graph`` core; replaces networkx
    preflow-push, which measured ~90% of a skeleton-dense threshold
    sweep).  Nodes are dense [0, n); ``components`` is a list of
    sequences of seed node indices.  Returns ``(labels, n_splits)``:
    a part label per node after all cuts, and the number of cuts."""
    lib = get_lib()
    eu = np.ascontiguousarray(edges_u, np.uint64)
    ev = np.ascontiguousarray(edges_v, np.uint64)
    cap = np.ascontiguousarray(capacities, np.float64)
    offs = np.zeros(len(components) + 1, np.uint64)
    flat = []
    for i, comp in enumerate(components):
        flat.extend(int(c) for c in comp)
        offs[i + 1] = len(flat)
    flat = np.ascontiguousarray(flat, np.uint64)
    labels = np.zeros(int(n_nodes), np.uint64)
    n = lib.split_graph_mincut(
        ctypes.c_uint64(int(n_nodes)), ctypes.c_uint64(len(eu)),
        _p(eu, ctypes.c_uint64), _p(ev, ctypes.c_uint64),
        _p(cap, ctypes.c_double),
        ctypes.c_uint64(len(components)),
        _p(offs, ctypes.c_uint64), _p(flat, ctypes.c_uint64),
        _p(labels, ctypes.c_uint64),
    )
    if n < 0:
        raise RuntimeError("split_graph_mincut failed")
    return labels, int(n)
