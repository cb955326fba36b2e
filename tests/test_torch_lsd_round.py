"""A 3d_mtlsd round through the port's entry points on the CPU, as
``tests/test_torch_round.py`` runs a 3d_affs one: ``make_round_configs``
without GT, then train (both heads) -> predict (both heads written) ->
segment -> evaluate by LSD errors -> filter.  Held against the JAX
package: the evaluation's LSD error maps on the port's segmentations
(within 1e-5, masks and stats equal) and the filter's output against the
host filter.  A narrow net, and a sigma of 8 in place of 80, keep the
error scan's blocks small."""

import json
import os

import numpy as np
import pytest

from bootstrapper_torch import configs
from bootstrapper_torch.core.arrays import open_ds, prepare_ds
from bootstrapper_torch.post.filter import compute_ids_to_remove
from bootstrapper_torch.utils import tomlio
from bootstrapper_torch.workflows import run_evaluation, run_filter, run_prediction, run_segmentation, run_training
from bootstrapper_tpu.core import arrays as JA
from bootstrapper_tpu.workflows.evaluate import run_evaluation as jax_run_evaluation

VOXEL = (40, 4, 4)
SHAPE = (14, 64, 64)
SIGMA = 8
TINY = dict(
    num_fmaps=2,
    fmap_inc_factor=2,
    input_shape=[14, 26, 26],
    output_shape=[2, 10, 10],
    shape_increase=[0, 0, 0],
    downsample_factors=[[1, 2, 2]],
    kernel_size_down=[[[3, 3, 3], [3, 3, 3]]] * 2,
    kernel_size_up=[[[3, 3, 3], [3, 3, 3]]],
)
NBHD = [[-1, 0, 0], [0, -1, 0], [0, 0, -1]]


def _volume(base):
    """Voronoi cells (ids past 2^32) with a band of background; raw dark
    on the cells' boundaries, noise."""
    rng = np.random.default_rng(0)
    pts = rng.uniform(0, 1, (12, 3)) * np.array(SHAPE)
    grid = np.stack(np.meshgrid(*[np.arange(s) for s in SHAPE], indexing="ij"), -1)
    d = (((grid[..., None, :] - pts) * np.array([10.0, 1.0, 1.0])) ** 2).sum(-1)
    labels = (d.argmin(-1) + 1).astype(np.uint64) << np.uint64(33)
    labels[:, :, :6] = 0
    raw = np.where(np.roll(labels, 1, 2) != labels, 40, 190) + rng.normal(0, 15, SHAPE)
    container = str(base / "vol.zarr")
    for name, data in [("raw", np.clip(raw, 0, 255).astype(np.uint8)), ("labels", labels)]:
        ds = prepare_ds(f"{container}/{name}", SHAPE, (0, 0, 0), VOXEL, data.dtype)
        ds[ds.roi] = data
    return container, {"vol": {
        "raw_dataset": f"{container}/raw", "labels_dataset": f"{container}/labels",
        "voxel_size": list(VOXEL), "output_container": container,
    }}


@pytest.fixture(scope="module")
def round1(tmp_path_factory):
    base = tmp_path_factory.mktemp("mtlsd")
    container, volumes = _volume(base)
    paths = configs.make_round_configs(str(base / "round_1"), volumes, ["3d_mtlsd"], max_iterations=3)
    setup = str(base / "round_1/setups/3d_mtlsd")
    with open(f"{setup}/net_config.json") as f:
        nc = json.load(f)
    nc.update(TINY)
    nc["outputs"]["3d_lsds"]["sigma"] = SIGMA
    nc["outputs"]["3d_affs"].update(neighborhood=NBHD, dims=3)
    with open(f"{setup}/net_config.json", "w") as f:
        json.dump(nc, f)
    ev = tomlio.load(paths["evaluate"])
    assert ev["evaluate"]["vol"]["pred"]["params"] == {"lsd_sigma": 80}
    ev["evaluate"]["vol"]["pred"]["params"]["lsd_sigma"] = SIGMA
    tomlio.dump(ev, paths["evaluate"])
    out = {"base": base, "container": container, "paths": paths}
    out["train"] = run_training(paths["train_3d_mtlsd"], device="cpu")
    out["predict"] = run_prediction(paths["predict"], device="cpu")
    out["segment"] = run_segmentation(paths["segment"], param_overrides=["thresholds=[0.5]"], device="cpu")
    out["evaluate"] = run_evaluation(paths["evaluate"], device="cpu")
    out["filter"] = run_filter(paths["filter"], num_workers=2)
    return out


def test_mtlsd_round_trains_and_predicts_both_heads(round1):
    assert round1["train"]["iterations"] == 3 and np.isfinite(round1["train"]["final_loss"])
    assert sorted(round1["predict"]) == ["vol/3d_mtlsd/2"]
    assert "steps_per_column" in round1["predict"]["vol/3d_mtlsd/2"]  # streamed
    for name, c in (("3d_lsds", 10), ("3d_affs", 3)):
        a = open_ds(f"{round1['container']}/3d_mtlsd/2/{name}").to_ndarray()
        assert a.shape == (c, *SHAPE) and a.dtype == np.uint8 and a.max() > 0


def test_mtlsd_round_evaluates_by_lsd_errors_as_jax(round1):
    """The evaluation scores the segmentation (about a thousand ids: four
    id chunks in a block) by LSD errors against the LSD head; the JAX
    package's evaluation from the same config agrees."""
    base = round1["base"]
    got = round1["evaluate"]["vol"]
    cfg = tomlio.load(round1["paths"]["evaluate"])
    cfg["evaluate"]["vol"]["out_result_dir"] = str(base / "eval_jax")
    tomlio.dump(cfg, str(base / "eval_jax.toml"))
    want = jax_run_evaluation(str(base / "eval_jax.toml"))["vol"]
    assert sorted(got) == sorted(want) and len(got) == 1
    for seg_path, entry in got.items():
        g, w = entry["pred_errors"], want[seg_path]["pred_errors"]
        assert "voi" not in entry and g["total_voxels"] == int(np.prod(SHAPE))
        gm, wm = open_ds(g["error_map"]).to_ndarray(), JA.open_ds(w["error_map"]).to_ndarray()
        np.testing.assert_allclose(gm, wm, rtol=0, atol=1e-5)
        np.testing.assert_array_equal(open_ds(g["error_mask"]).to_ndarray(), JA.open_ds(w["error_mask"]).to_ndarray())
        for k in ("nonzero_ratio", "total_voxels", "nonzero_voxels"):
            assert g[k] == w[k], k


def test_mtlsd_round_filter_writes_pseudo_gt(round1):
    res = round1["filter"]["vol"]
    results = round1["evaluate"]["vol"]
    best = min(results, key=lambda p: results[p]["pred_errors"]["nonzero_ratio"])
    assert res["source_segmentation"] == best
    src = open_ds(best).to_ndarray()
    labels = open_ds(f"{round1['container']}/pseudo_gt/round_1/labels").to_ndarray()
    mask = open_ds(f"{round1['container']}/pseudo_gt/round_1/mask").to_ndarray()
    removed = compute_ids_to_remove(src, 500, True, 10)
    assert res["removed_ids"] == len(removed)
    np.testing.assert_array_equal(labels, np.where(np.isin(src, removed), 0, src))
    err_mask = open_ds(results[best]["pred_errors"]["error_mask"]).to_ndarray()
    np.testing.assert_array_equal(mask, ((labels > 0) & (err_mask == 0)).astype(np.uint8))
    assert os.path.exists(round1["base"] / "round_1" / "next_volumes.toml")
