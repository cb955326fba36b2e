"""The port's filter stage against the JAX package's, on the same seeded
segmentations: the global id filter, the blockwise filter that writes the
next round's labels and mask, the standalone size and outlier filters,
and ``run_filter``'s choice of segmentation from an evaluation JSON.  All
of it is integer host work, so every result must be equal."""

import json

import numpy as np
import pytest

from bootstrapper_torch.core import arrays as A
from bootstrapper_torch.core.geometry import Roi
from bootstrapper_torch.post import filter as F
from bootstrapper_torch.post.filter import compute_ids_to_remove, outlier_filter, size_filter
from bootstrapper_torch.utils import tomlio
from bootstrapper_torch.workflows import run_filter
from bootstrapper_torch.workflows.filter import get_best_seg_from_eval
from bootstrapper_tpu.core import arrays as JA
from bootstrapper_tpu.core.geometry import Roi as JRoi
from bootstrapper_tpu.post import filter as JF
from bootstrapper_tpu.workflows import filter as JWF

VOXEL = (4, 2, 2)


def _segmentation(seed=0, shape=(12, 40, 36)):
    """Voronoi cells with ids past 2^32, a background band, dust, pieces
    that exist in one or two sections, a cell that moves between sections
    and one cell far larger than the rest."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, 1, (30, 3)) * np.array(shape)
    grid = np.stack(np.meshgrid(*[np.arange(s) for s in shape], indexing="ij"), -1)
    d = (((grid[..., None, :] - pts) * np.array([3.0, 1.0, 1.0])) ** 2).sum(-1)
    seg = (d.argmin(-1) + 1).astype(np.uint64) << np.uint64(33)
    seg[:, :, :3] = 0
    seg[:, 16:, 12:] = 7  # the large outlier
    for i in range(6):  # dust
        z, y, x = rng.integers(0, shape[0]), rng.integers(0, 30), rng.integers(3, 36)
        seg[z, y, x] = 100 + i
    seg[4:6, 2:6, 5:9] = 200  # two sections only
    seg[0, 10:14, 10:14] = 300  # present at z=0, then jumps
    seg[1, 20:24, 20:24] = 300
    return seg


FILTERS = {
    "dust": dict(dust_filter=20),
    "outliers": dict(remove_outliers=True),
    "z_fragments": dict(remove_z_fragments=3),
    "overlap": dict(overlap_filter=0.5),
    "all": dict(dust_filter=20, remove_outliers=True, remove_z_fragments=3, overlap_filter=0.5),
}


@pytest.mark.parametrize("name", sorted(FILTERS))
def test_compute_ids_to_remove_matches_jax(name):
    seg = _segmentation()
    got = compute_ids_to_remove(seg, **FILTERS[name])
    np.testing.assert_array_equal(got, JF.compute_ids_to_remove(seg, **FILTERS[name]))
    assert len(got) > 0


@pytest.fixture
def seg_zarr(tmp_path):
    seg = _segmentation()
    ds = A.prepare_ds(str(tmp_path / "f.zarr/seg"), seg.shape, (0, 0, 0), VOXEL, np.uint64)
    ds[ds.roi] = seg
    err = (np.random.default_rng(1).random(seg.shape) < 0.2).astype(np.uint8)
    es = A.prepare_ds(str(tmp_path / "f.zarr/err"), err.shape, (0, 0, 0), VOXEL, np.uint8)
    es[es.roi] = err
    return {"seg": ds.path, "err": es.path, "dir": tmp_path}


BLOCKWISE = {
    "plain": dict(),
    "error_mask": dict(error_mask=True),
    "erode": dict(error_mask=True, erode_out_mask=True),
    "roi": dict(roi=((8, 4, 6), (24, 56, 48))),
}


@pytest.mark.parametrize("name", sorted(BLOCKWISE))
def test_filter_segmentation_blockwise_matches_jax(seg_zarr, name):
    opts = dict(BLOCKWISE[name])
    roi = opts.pop("roi", None)
    err = seg_zarr["err"] if opts.pop("error_mask", False) else None

    def run(pkg, open_ds, Roi, out):
        d = seg_zarr["dir"] / out
        res = pkg.filter_segmentation_blockwise(
            seg_zarr["seg"], str(d / "labels"), str(d / "mask"), error_mask_path=err,
            dust_filter=20, remove_outliers=True, remove_z_fragments=3,
            block_shape=(4, 16, 16), num_workers=3, roi=None if roi is None else Roi(*roi), **opts,
        )
        return res, open_ds(str(d / "labels")).to_ndarray(), open_ds(str(d / "mask")).to_ndarray()

    res, labels, mask = run(F, A.open_ds, Roi, "port.zarr")
    jres, jlabels, jmask = run(JF, JA.open_ds, JRoi, "jax.zarr")
    assert res["removed_ids"] == jres["removed_ids"] > 0
    np.testing.assert_array_equal(labels, jlabels)
    np.testing.assert_array_equal(mask, jmask)
    assert 0 < mask.mean() < 1


@pytest.mark.parametrize("relabel_cc", [False, True])
def test_size_and_outlier_filters_match_jax(relabel_cc):
    seg = _segmentation()[5]
    np.testing.assert_array_equal(
        size_filter(seg, 20, relabel_cc=relabel_cc), JF.size_filter(seg, 20, relabel_cc=relabel_cc)
    )
    np.testing.assert_array_equal(
        outlier_filter(seg, 2.0, relabel_cc=relabel_cc), JF.outlier_filter(seg, 2.0, relabel_cc=relabel_cc)
    )


EVAL_RESULTS = {
    # each scored by one key, as the evaluate workflow writes them
    "voi": {"a": {"voi": {"voi_sum": 0.9}}, "b": {"voi": {"voi_sum": 0.4}}, "c": {"voi": {"voi_sum": 1.3}}},
    "nerl": {"a": {"skeletons": {"nerl": 0.2}}, "b": {"skeletons": {"nerl": 0.7}}, "c": {"skeletons": {"nerl": 0.5}}},
    "error_ratio": {
        "a": {"pred_errors": {"nonzero_ratio": 0.3, "error_mask": "a_err"}},
        "b": {"pred_errors": {"nonzero_ratio": 0.1, "error_mask": "b_err"}},
        "c": {"pred_errors": {"nonzero_ratio": 0.2, "error_mask": "c_err"}},
    },
}


@pytest.mark.parametrize("score", sorted(EVAL_RESULTS))
def test_run_filter_picks_best_segmentation(seg_zarr, score):
    """``run_filter`` filters the segmentation the evaluation JSON scores
    best, with its error mask where it has one."""
    d = seg_zarr["dir"]
    results = {seg_zarr["seg"] if k == "b" else str(d / k): v for k, v in EVAL_RESULTS[score].items()}
    if score == "error_ratio":
        results[seg_zarr["seg"]]["pred_errors"]["error_mask"] = seg_zarr["err"]
    results["threshold_sweep"] = {"thresholds": {}}  # not a segmentation
    (d / "eval").mkdir()
    eval_json = str(d / "eval" / "vol_results.json")
    with open(eval_json, "w") as f:
        json.dump(results, f)
    best = get_best_seg_from_eval(eval_json)
    assert best == JWF.get_best_seg_from_eval(eval_json)
    assert best[0] == seg_zarr["seg"]
    tomlio.dump({"filter": {"vol": {
        "eval_dir": str(d / "eval"),
        "out_seg_dataset_prefix": str(d / "out.zarr/labels"),
        "out_mask_dataset_prefix": str(d / "out.zarr/mask"),
        "dust_filter": 20,
    }}}, str(d / "filter.toml"))
    res = run_filter(str(d / "filter.toml"), num_workers=2, block_shape=(4, 16, 16), param_overrides=["remove_z_fragments=3"])
    assert res["vol"]["source_segmentation"] == seg_zarr["seg"]
    seg = A.open_ds(seg_zarr["seg"]).to_ndarray()
    labels = A.open_ds(str(d / "out.zarr/labels")).to_ndarray()
    mask = A.open_ds(str(d / "out.zarr/mask")).to_ndarray()
    removed = compute_ids_to_remove(seg, 20, True, 3)
    np.testing.assert_array_equal(labels, np.where(np.isin(seg, removed), 0, seg))
    want = labels > 0
    if score == "error_ratio":
        want &= A.open_ds(seg_zarr["err"]).to_ndarray() == 0
    np.testing.assert_array_equal(mask, want.astype(np.uint8))
