"""The port's evaluation stage against the JAX package's, on the same
seeded inputs: VOI, the GT metrics, the prediction-error map (the
port on the CPU), the threshold sweep and the skeleton metrics.  Inputs
are written once as uncompressed Zarr and opened by both packages.

Tolerances: VOI, Rand and ERL scores are the same float64 arithmetic on
the same counts, held to 1e-12; the error map is a mean of nine fp32
squares summed in another order, held to 1e-6, and its mask must agree
except where the error lies within 1e-6 of a threshold (a tie)."""

import networkx as nx
import numpy as np
import pytest

from bootstrapper_torch.core import arrays as A
from bootstrapper_torch.eval import compute_aff_errors, compute_lsd_errors, compute_metrics, rand_voi
from bootstrapper_torch.eval import voi as V
from bootstrapper_torch.eval.skeletons import skeleton_metrics
from bootstrapper_torch.eval.thresholds import evaluate_thresholds
from bootstrapper_torch.models.zoo import get_net_config
from bootstrapper_torch.post.rag import RagDB
from bootstrapper_torch.utils import tomlio
from bootstrapper_torch.workflows import run_evaluation
from bootstrapper_tpu.core import arrays as JA
from bootstrapper_tpu.eval import errors as JE
from bootstrapper_tpu.eval import metrics as JM
from bootstrapper_tpu.eval import skeletons as JS
from bootstrapper_tpu.eval import thresholds as JT
from bootstrapper_tpu.eval import voi as JV
from bootstrapper_tpu.post.rag import RagDB as JRagDB

SCORE_ATOL = 1e-12
ERR_ATOL = 1e-6
NBHD_3D_AFFS = get_net_config("3d_affs")["outputs"]["3d_affs"]["neighborhood"]


def _write(path, a, voxel_size=(1, 1, 1), chunk_shape=None):
    ds = A.prepare_ds(str(path), a.shape, (0,) * len(voxel_size), voxel_size, a.dtype,
                      chunk_shape=chunk_shape)
    ds[ds.roi] = a
    return str(path)


def _blobs(shape, n, seed, base=1):
    """Voronoi cells with ids ``base + k`` and a band of background."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, 1, (n, 3)) * np.array(shape)
    grid = np.stack(np.meshgrid(*[np.arange(s) for s in shape], indexing="ij"), -1)
    d = (((grid[..., None, :] - pts) * np.array([3.0, 1.0, 1.0])) ** 2).sum(-1)
    lab = (d.argmin(-1) + base).astype(np.uint64)
    lab[:, :, :2] = 0
    return lab


def _scores_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k] == pytest.approx(b[k], abs=SCORE_ATOL), k


# -- VOI ---------------------------------------------------------------------

VOI_CASES = {
    "small_ids": (1, 1),
    "ids_past_2^32": (2**33 + 1, 2**40 + 3),
}


@pytest.mark.parametrize("route", ["native", "numpy"])
@pytest.mark.parametrize("ignore_gt_zero", [True, False])
@pytest.mark.parametrize("case", sorted(VOI_CASES))
def test_rand_voi_matches_jax(case, ignore_gt_zero, route, monkeypatch):
    gt_base, seg_base = VOI_CASES[case]
    gt = _blobs((6, 20, 20), 9, 0, gt_base)
    seg = _blobs((6, 20, 20), 14, 1, seg_base)
    if route == "numpy":
        monkeypatch.setattr(V, "_contingency", V._contingency_numpy)
        monkeypatch.setattr(JV, "_contingency", JV._contingency_numpy)
    got = rand_voi(gt, seg, ignore_gt_zero=ignore_gt_zero)
    _scores_equal(got, JV.rand_voi(gt, seg, ignore_gt_zero=ignore_gt_zero))
    assert got["voi_split"] > 0 and got["voi_merge"] > 0


@pytest.mark.parametrize("with_mask", [False, True])
def test_compute_metrics_matches_jax(tmp_path, with_mask):
    gt = _blobs((6, 20, 20), 9, 0)
    seg = _blobs((6, 20, 20), 14, 1, 2**35)
    mask = np.ones(gt.shape, np.uint8)
    mask[:2] = 0
    paths = {k: _write(tmp_path / "m.zarr" / k, a, (4, 2, 2)) for k, a in
             {"gt": gt, "seg": seg, "mask": mask}.items()}
    kw = lambda pkg: {
        "gt_labels": pkg.open_ds(paths["gt"]),
        "mask": pkg.open_ds(paths["mask"]) if with_mask else None,
    }
    got = compute_metrics(A.open_ds(paths["seg"]), **kw(A))
    want = JM.compute_metrics(JA.open_ds(paths["seg"]), **kw(JA))
    _scores_equal(got["voi"], want["voi"])


# -- prediction errors ---------------------------------------------------------


def _error_case(tmp_path, shape, seed):
    """Seeded ids below 2^31 and uint8 predictions: the affinities of a
    slightly different segmentation, plus noise."""
    rng = np.random.default_rng(seed)
    seg = _blobs(shape, 12, seed, 1000)
    other = _blobs(shape, 12, seed + 1, 1000)
    affs = np.stack([
        (other == np.roll(other, tuple(-np.array(o)), (0, 1, 2))) & (other > 0) for o in NBHD_3D_AFFS
    ]).astype(np.float32)
    pred = np.clip(affs * 255 + rng.normal(0, 40, affs.shape), 0, 255).astype(np.uint8)
    return (_write(tmp_path / "e.zarr/seg", seg, (4, 2, 2)),
            _write(tmp_path / "e.zarr/pred", pred, (4, 2, 2)))


def _compare_errors(got, want):
    """The two routes' results: map within ERR_ATOL, masks equal except on
    ties, the stats equal.  Returns the number of ties."""
    gm, wm = A.open_ds(got["error_map"]).to_ndarray(), JA.open_ds(want["error_map"]).to_ndarray()
    np.testing.assert_allclose(gm, wm, rtol=0, atol=ERR_ATOL)
    tie = (np.abs(wm - 0.1) <= ERR_ATOL) | (np.abs(wm - 1.0) <= ERR_ATOL)
    gk, wk = A.open_ds(got["error_mask"]).to_ndarray(), JA.open_ds(want["error_mask"]).to_ndarray()
    assert ((gk == wk) | tie).all()
    for k in ("nonzero_ratio", "total_voxels", "nonzero_voxels"):
        assert got[k] == want[k], k
    return int(tie.sum())


ERROR_CASES = {
    # volume, block: the ROI smaller than one block (it clamps); a volume
    # that is no multiple of the block (edge blocks overlap and their
    # overlap is counted once)
    "roi_below_block": ((6, 20, 20), (16, 128, 128)),
    "overlapping_edges": ((10, 26, 22), (4, 12, 8)),
}


@pytest.mark.parametrize("case", sorted(ERROR_CASES))
def test_compute_aff_errors_matches_jax(tmp_path, case):
    shape, block = ERROR_CASES[case]
    seg_path, pred_path = _error_case(tmp_path, shape, 3)
    got = compute_aff_errors(A.open_ds(seg_path), A.open_ds(pred_path), NBHD_3D_AFFS,
                             str(tmp_path / "port.zarr"), block_shape=block, device="cpu")
    want = JE.compute_aff_errors(JA.open_ds(seg_path), JA.open_ds(pred_path), NBHD_3D_AFFS,
                                 str(tmp_path / "jax.zarr"), block_shape=block)
    assert _compare_errors(got, want) == 0
    assert got["total_voxels"] == int(np.prod(shape))
    assert 0 < got["nonzero_ratio"] < 1


@pytest.mark.parametrize("total, tile", [
    (((0, 0, 0), (10, 26, 22)), (4, 12, 8)),
    (((3, 8, 4), (40, 64, 30)), (8, 16, 30)),
    (((0, 0, 0), (6, 20, 20)), (6, 20, 20)),
])
def test_tile_rois_with_fresh_matches_jax(total, tile):
    """The error scan's blocks and the parts no earlier block covers,
    which partition the ROI."""
    from bootstrapper_torch.core.geometry import Coordinate, Roi
    from bootstrapper_torch.predict.scan import tile_rois
    from bootstrapper_tpu.core.geometry import Coordinate as JCoordinate
    from bootstrapper_tpu.core.geometry import Roi as JRoi
    from bootstrapper_tpu.predict.scan import tile_rois as jax_tile_rois

    got = tile_rois(Roi(*total), Coordinate(tile), with_fresh=True)
    want = jax_tile_rois(JRoi(*total), JCoordinate(tile), with_fresh=True)
    assert [(repr(t), repr(f)) for t, f in got] == [(repr(t), repr(f)) for t, f in want]
    assert sum(f.size for _, f in got) == Roi(*total).size


def _numpy_errors(seg, pred, nbhd):
    """The error map on exact uint64 ids, in numpy: the reference for ids
    the JAX package's int32 cast would change."""
    affs = []
    for o in nbhd:
        partner = np.zeros_like(seg)
        src = tuple(slice(max(k, 0), n + min(k, 0)) for k, n in zip(o, seg.shape))
        dst = tuple(slice(max(-k, 0), n - max(k, 0)) for k, n in zip(o, seg.shape))
        partner[dst] = seg[src]
        affs.append((seg == partner) & (seg > 0) & (partner > 0))
    err = ((np.stack(affs).astype(np.float32) - pred) ** 2).sum(0) / np.float32(len(nbhd))
    return err, ((err > 0.1) & (err <= 1.0)).astype(np.uint8)


@pytest.mark.parametrize("ids", [(2**31 + 7, 5), (2**32 + 5, 5)])
def test_compute_aff_errors_exact_for_large_ids(tmp_path, ids):
    """Ids at or above 2^31 score as themselves (the JAX package casts
    them to int32: 2^31+7 becomes background, 2^32+5 merges with 5)."""
    import torch

    from bootstrapper_torch.ops.affinities import seg_to_affs

    nbhd = [[-1, 0, 0], [0, -1, 0], [0, 0, -1]]
    seg = np.full((2, 4, 4), ids[1], np.uint64)
    seg[:, :, :2] = ids[0]
    # the pair of halves the JAX package scores wrongly: positive sums per
    # channel of the exact map
    from bootstrapper_torch.train.sampler import renumber

    sums = seg_to_affs(torch.from_numpy(renumber(seg)), nbhd).sum((1, 2, 3))
    assert sums.tolist() == [16, 24, 16]
    rng = np.random.default_rng(0)
    pred = rng.integers(0, 256, (3, 2, 4, 4)).astype(np.uint8)
    got = compute_aff_errors(A.open_ds(_write(tmp_path / "s.zarr/seg", seg)),
                             A.open_ds(_write(tmp_path / "s.zarr/pred", pred)),
                             nbhd, str(tmp_path / "out.zarr"), device="cpu")
    err, mask = _numpy_errors(seg, pred.astype(np.float32) / np.float32(255.0), nbhd)
    np.testing.assert_allclose(A.open_ds(got["error_map"]).to_ndarray(), err, rtol=0, atol=ERR_ATOL)
    np.testing.assert_array_equal(A.open_ds(got["error_mask"]).to_ndarray(), mask)
    assert got["nonzero_voxels"] == int(mask.sum())
    # the departure kept on purpose: the JAX package's map differs here
    want = JE.compute_aff_errors(JA.open_ds(str(tmp_path / "s.zarr/seg")), JA.open_ds(str(tmp_path / "s.zarr/pred")),
                                 nbhd, str(tmp_path / "jax.zarr"))
    assert np.abs(JA.open_ds(want["error_map"]).to_ndarray() - err).max() > 0.1


LSD_ATOL = 1e-5
LSD_ERROR_CASES = {
    # volume, cells, block: one block holding over 255 ids (two id chunks
    # of 255); three overlapping blocks of fewer ids
    "over_255_ids": ((4, 32, 32), 300, (16, 128, 128)),
    "overlapping_blocks": ((6, 32, 24), 30, (6, 12, 24)),
}


@pytest.mark.parametrize("case", sorted(LSD_ERROR_CASES))
def test_compute_lsd_errors_raises(tmp_path, case):
    """The LSD error map on the CPU against the JAX package's, ids below
    2^31 (fp32 blurs summed in another order): within 1e-5, the masks and
    the stats equal."""
    shape, cells, block = LSD_ERROR_CASES[case]
    rng = np.random.default_rng(7)
    ids = (rng.choice(2**31 - 2, cells, replace=False) + 1).astype(np.uint64)
    seg = ids[_blobs(shape, cells, 7, base=0).astype(np.int64)]
    seg[:, :, :2] = 0
    pred = rng.integers(0, 256, (10, *shape)).astype(np.uint8)
    seg_path = _write(tmp_path / "l.zarr/seg", seg)
    pred_path = _write(tmp_path / "l.zarr/pred", pred)
    kw = dict(sigma=2.0, block_shape=block)
    got = compute_lsd_errors(A.open_ds(seg_path), A.open_ds(pred_path), out_container=str(tmp_path / "port.zarr"),
                             device="cpu", **kw)
    want = JE.compute_lsd_errors(JA.open_ds(seg_path), JA.open_ds(pred_path), out_container=str(tmp_path / "jax.zarr"),
                                 **kw)
    gm, wm = A.open_ds(got["error_map"]).to_ndarray(), JA.open_ds(want["error_map"]).to_ndarray()
    np.testing.assert_allclose(gm, wm, rtol=0, atol=LSD_ATOL)
    np.testing.assert_array_equal(A.open_ds(got["error_mask"]).to_ndarray(), JA.open_ds(want["error_mask"]).to_ndarray())
    for k in ("nonzero_ratio", "total_voxels", "nonzero_voxels"):
        assert got[k] == want[k], k
    assert got["total_voxels"] == int(np.prod(shape)) and 0 < got["nonzero_ratio"] < 1
    if case == "over_255_ids":
        assert len(np.unique(seg)) > 256


# -- threshold sweep and skeletons (tests/test_thresholds.py's RAG) ---------------


@pytest.fixture
def rag_case(tmp_path):
    """Four fragments in a row; the RAG merges 1-2 at 0.1, 3-4 at 0.2,
    2-3 at 0.8; GT objects {1,2} and {3,4}; one skeleton in each."""
    frags = np.zeros((2, 4, 8), np.uint64)
    for i in range(4):
        frags[:, :, 2 * i:2 * i + 2] = i + 1
    gt = np.where(frags <= 2, 10, 20).astype(np.uint64)
    paths = {"frags": _write(tmp_path / "t.zarr/frags", frags), "gt": _write(tmp_path / "t.zarr/gt", gt)}
    rag = RagDB(str(tmp_path / "rag.db"), mode="w")
    rag.write_nodes([1, 2, 3, 4], np.array([[1, 2, 1], [1, 2, 3], [1, 2, 5], [1, 2, 7.0]]))
    rag.write_edges([1, 3, 2], [2, 4, 3], [0.1, 0.2, 0.8])
    g = nx.Graph()
    for i, x in enumerate([0.5, 2.5, 3.5]):
        g.add_node(f"a{i}", position_z=0.0, position_y=2.0, position_x=x, skeleton_id="a")
    g.add_edges_from([("a0", "a1"), ("a1", "a2")])
    for i, x in enumerate([4.5, 6.5]):
        g.add_node(f"b{i}", position_z=0.0, position_y=2.0, position_x=x, skeleton_id="b")
    g.add_edge("b0", "b1")
    paths["skels"] = str(tmp_path / "skels.graphml")
    nx.write_graphml(g, paths["skels"])
    paths["rag"] = str(tmp_path / "rag.db")
    return paths


def _close(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _close(a[k], b[k])
    elif isinstance(a, float):
        assert a == pytest.approx(b, abs=SCORE_ATOL)
    else:
        assert a == b


@pytest.mark.parametrize("workers", [1, 3])
def test_evaluate_thresholds_matches_jax(rag_case, workers):
    def run(pkg, sweep, Rag):
        return sweep(
            pkg.open_ds(rag_case["frags"]), Rag(rag_case["rag"], mode="r"), [0.05, 0.15, 0.5, 0.9],
            gt_labels=pkg.open_ds(rag_case["gt"]), gt_skeletons=rag_case["skels"], num_workers=workers,
        )

    got = run(A, evaluate_thresholds, RagDB)
    _close(got, run(JA, JT.evaluate_thresholds, JRagDB))
    assert got["best_voi"]["threshold"] == 0.5 and got["best_nerl"]["threshold"] == 0.5


def test_skeleton_metrics_matches_jax(rag_case):
    got = skeleton_metrics(A.open_ds(rag_case["frags"]), rag_case["skels"])
    _close(got, JS.skeleton_metrics(JA.open_ds(rag_case["frags"]), rag_case["skels"]))
    # a in fragments 1 and 2: one split; b in fragments 3 and 4: one split
    assert got["split_count"] == 2


def test_run_evaluation_threshold_sweep(rag_case, tmp_path):
    """The evaluate workflow's ``threshold_sweep`` branch on a RAG written
    by hand."""
    cfg = {"evaluate": {"vol": {
        "out_result_dir": str(tmp_path / "eval"),
        "seg_datasets_prefix": str(tmp_path / "none"),
        "threshold_sweep": {"fragments_dataset": rag_case["frags"], "rag_db": rag_case["rag"],
                            "thresholds": [0.05, 0.5, 0.9]},
        "gt": {"labels_dataset": rag_case["gt"]},
    }}}
    p = str(tmp_path / "eval.toml")
    tomlio.dump(cfg, p)
    sweep = run_evaluation(p, device="cpu")["vol"]["threshold_sweep"]
    assert sweep["best_voi"]["threshold"] == 0.5 and set(sweep["thresholds"]) == {"0.05", "0.5", "0.9"}
