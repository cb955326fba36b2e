"""One whole round through the port's entry points on the CPU, as
``tests/test_cli_round.py`` runs it through the JAX package: the port's
``make_round_configs`` writes the round, then train -> predict -> segment
-> evaluate -> filter, and round 2's configs from round 1's
``next_volumes.toml`` train on the pseudo-GT.  Held against the JAX
package: the round's configs (equal dicts once the root directory is
substituted), the VOI of the round's segmentation, and the no-GT
evaluation's error map (within 1e-6, the masks equal except on ties,
expected 0).  Last, the workflows without networkx, in a fresh
interpreter."""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from bootstrapper_torch import configs
from bootstrapper_torch.core.arrays import open_ds, prepare_ds
from bootstrapper_torch.models.weights import save_checkpoint
from bootstrapper_torch.post.filter import compute_ids_to_remove
from bootstrapper_torch.utils import tomlio
from bootstrapper_torch.workflows import (
    run_evaluation,
    run_filter,
    run_prediction,
    run_segmentation,
    run_training,
)
from bootstrapper_tpu import configs as jconfigs
from bootstrapper_tpu.core import arrays as JA
from bootstrapper_tpu.eval.voi import rand_voi as jax_rand_voi
from bootstrapper_tpu.models.model import Model as JModel
from bootstrapper_tpu.workflows.evaluate import run_evaluation as jax_run_evaluation

ERR_ATOL = 1e-6
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tests/test_cli_round.py's narrow net
TINY_3D_NET = dict(
    num_fmaps=2,
    fmap_inc_factor=2,
    input_shape=[12, 48, 48],
    output_shape=[4, 8, 8],
    shape_increase=[0, 0, 0],
    downsample_factors=[[1, 2, 2]] * 2,
    kernel_size_down=[
        [[1, 3, 3], [1, 3, 3]],
        [[3, 3, 3], [3, 3, 3]],
        [[3, 3, 3], [3, 3, 3]],
    ],
    kernel_size_up=[[[1, 3, 3], [1, 3, 3]], [[1, 3, 3], [1, 3, 3]]],
)
NBHD = [[-1, 0, 0], [0, -1, 0], [0, 0, -1]]


def _shrink(setup_dir):
    path = os.path.join(setup_dir, "net_config.json")
    with open(path) as f:
        nc = json.load(f)
    nc.update(TINY_3D_NET)
    nc["outputs"]["3d_affs"]["neighborhood"] = NBHD
    nc["outputs"]["3d_affs"]["dims"] = 3
    with open(path, "w") as f:
        json.dump(nc, f)


def _volume(base):
    """tests/test_cli_round.py's (24, 96, 96) volume: two objects, a dark
    band between them, noise."""
    shape, vs = (24, 96, 96), (1, 1, 1)
    rng = np.random.default_rng(0)
    labels = np.zeros(shape, np.uint32)
    labels[:, :48, :] = 1
    labels[:, 48:, :] = 2
    raw = np.full(shape, 200, np.float32)
    raw[:, 46:50, :] = 30
    raw += rng.normal(0, 10, shape)
    raw = np.clip(raw, 0, 255).astype(np.uint8)
    container = str(base / "vol.zarr")
    for name, data in [("raw", raw), ("labels", labels)]:
        ds = prepare_ds(f"{container}/{name}", shape, (0, 0, 0), vs, data.dtype)
        ds[ds.roi] = data
    volumes = {"vol": {
        "raw_dataset": f"{container}/raw",
        "labels_dataset": f"{container}/labels",
        "voxel_size": list(vs),
        "output_container": container,
    }}
    return container, volumes


def _substituted(d, root):
    """A config dict with ``root`` replaced by ``<root>`` in every string."""
    if isinstance(d, dict):
        return {k: _substituted(v, root) for k, v in d.items()}
    if isinstance(d, list):
        return [_substituted(v, root) for v in d]
    return d.replace(root, "<root>") if isinstance(d, str) else d


ROUND_CONFIGS = {
    "gt": dict(gt_labels="labels"),
    "no_gt": dict(),
    "chain": dict(model_names=["3d_lsd", "3d_affs_from_3d_lsd"]),
    # the 2D chain, scored by VOI and, without GT, by the refiner's errors
    "chain_2d": dict(model_names=["2d_mtlsd", "3d_affs_from_2d_mtlsd"], gt_labels="labels"),
    "chain_2d_no_gt": dict(model_names=["2d_mtlsd", "3d_affs_from_2d_mtlsd"]),
}


@pytest.mark.parametrize("case", sorted(ROUND_CONFIGS))
def test_make_round_configs_matches_jax(tmp_path, case):
    kw = dict(ROUND_CONFIGS[case])
    names = kw.pop("model_names", ["3d_affs"])
    out = {}
    for pkg, name in [(configs, "port"), (jconfigs, "jax")]:
        root = str(tmp_path / name)
        container = os.path.join(root, "vol.zarr")
        volumes = {"vol": {"raw_dataset": f"{container}/raw", "labels_dataset": f"{container}/labels",
                           "voxel_size": [40, 4, 4], "output_container": container}}
        if "gt_labels" in kw:
            kw["gt_labels"] = f"{container}/labels"
        paths = pkg.make_round_configs(os.path.join(root, "round_1"), volumes, names, max_iterations=50, **kw)
        files = sorted(os.path.relpath(os.path.join(d, f), root)
                       for d, _, fs in os.walk(os.path.join(root, "round_1")) for f in fs)
        loaded = {}
        for f in files:
            p = os.path.join(root, f)
            loaded[f] = tomlio.load(p) if f.endswith(".toml") else open(p, "rb").read()
        out[name] = (_substituted(paths, root), _substituted(loaded, root))
    assert out["port"] == out["jax"]
    assert "round_1/next_volumes.toml" in out["port"][1]


@pytest.fixture(scope="module")
def round1(tmp_path_factory):
    """Round 1 written by the port's ``make_round_configs`` and run through
    its entry points on the CPU."""
    base = tmp_path_factory.mktemp("round")
    container, volumes = _volume(base)
    tomlio.dump({"volumes": volumes}, str(base / "volumes.toml"))
    paths = configs.make_round_configs(
        str(base / "round_1"), volumes, ["3d_affs"], max_iterations=30, gt_labels=f"{container}/labels"
    )
    setup = str(base / "round_1/setups/3d_affs")
    _shrink(setup)
    # start from the parameters tests/test_cli_round.py trains from (the
    # JAX package's init at seed 0): at this width init_params_numpy's seed
    # 0 leaves the net at the constant-prediction loss floor in both
    # packages, and its empty segmentation would give round 2 no labels
    params = JModel.from_setup(setup).init(jax.random.PRNGKey(0))
    save_checkpoint(setup, jax.tree_util.tree_map(np.asarray, params), 0)
    out = {"base": base, "container": container, "paths": paths, "volumes": volumes}
    out["train"] = run_training(paths["train_3d_affs"], device="cpu")
    out["predict"] = run_prediction(paths["predict"], device="cpu")
    out["segment"] = run_segmentation(paths["segment"], param_overrides=["thresholds=[0.3,0.5]"], device="cpu")
    out["evaluate"] = run_evaluation(paths["evaluate"], device="cpu")
    out["filter"] = run_filter(paths["filter"], num_workers=2)
    return out


def test_round_trains_and_predicts(round1):
    base = round1["base"]
    assert round1["train"]["iterations"] == 30
    assert os.path.exists(base / "round_1/setups/3d_affs/model_checkpoint_30")
    # the predict chain names iteration 29 (max_iterations - 1) and falls
    # back to the latest checkpoint, as in the JAX package
    affs = open_ds(f"{round1['container']}/3d_affs/29/3d_affs").to_ndarray()
    assert affs.shape == (3, 24, 96, 96) and affs.dtype == np.uint8 and affs.max() > 0


def test_round_segments_and_evaluates(round1):
    seg_dir = f"{round1['container']}/post/29/segmentations_ws"
    assert sorted(os.listdir(seg_dir)) == ["mean--0_3", "mean--0_5"]
    with open(f"{round1['container']}/eval/vol_results.json") as f:
        results = json.load(f)
    assert sorted(results) == sorted(os.path.join(seg_dir, s) for s in os.listdir(seg_dir))
    for path, entry in results.items():
        # VOI of the port's segmentation against the JAX package's rand_voi
        # on the same arrays
        want = jax_rand_voi(open_ds(f"{round1['container']}/labels").to_ndarray(), open_ds(path).to_ndarray())
        for k, v in want.items():
            assert entry["voi"][k] == pytest.approx(v, abs=1e-12), k


def test_round_filter_writes_pseudo_gt(round1):
    res = round1["filter"]["vol"]
    src = open_ds(res["source_segmentation"]).to_ndarray()
    labels = open_ds(f"{round1['container']}/pseudo_gt/round_1/labels").to_ndarray()
    mask = open_ds(f"{round1['container']}/pseudo_gt/round_1/mask").to_ndarray()
    # every voxel is the source's or 0, the removed ids are the host
    # filter's, and the mask is the kept labels (no error mask with GT)
    removed = compute_ids_to_remove(src, 500, True, 10)
    assert res["removed_ids"] == len(removed)
    np.testing.assert_array_equal(labels, np.where(np.isin(src, removed), 0, src))
    np.testing.assert_array_equal(mask, (labels > 0).astype(np.uint8))
    assert mask.mean() > 0.5


def test_round_2_trains_on_pseudo_gt(round1):
    base = round1["base"]
    paths = configs.make_round_configs(
        str(base / "round_2"), tomlio.load(str(base / "round_1/next_volumes.toml"))["volumes"],
        ["3d_affs"], max_iterations=3,
    )
    sample = tomlio.load(paths["train_3d_affs"])["train"]["samples"][0]
    assert "pseudo_gt" in sample["labels"] and "pseudo_gt" in sample["mask"]
    _shrink(str(base / "round_2/setups/3d_affs"))
    res = run_training(paths["train_3d_affs"], device="cpu")
    assert res["iterations"] == 3
    assert os.path.exists(base / "round_2/setups/3d_affs/model_checkpoint_3")


def _no_gt_config(round1, out_dir):
    """The evaluate config ``make_round_configs`` writes without GT
    (prediction errors) for round 1's predictions, with its results under
    ``out_dir``."""
    base = round1["base"]
    paths = configs.make_round_configs(str(base / "nogt"), round1["volumes"], ["3d_affs"], max_iterations=30)
    cfg = tomlio.load(paths["evaluate"])
    cfg["evaluate"]["vol"]["out_result_dir"] = str(out_dir)
    # the zoo net's neighbourhood, as written, is the narrow net's here
    cfg["evaluate"]["vol"]["pred"]["params"]["aff_neighborhood"] = NBHD
    p = str(out_dir) + ".toml"
    tomlio.dump(cfg, p)
    return p


def test_no_gt_evaluation_matches_jax(round1):
    base = round1["base"]
    got = run_evaluation(_no_gt_config(round1, base / "eval_port"), device="cpu")["vol"]
    want = jax_run_evaluation(_no_gt_config(round1, base / "eval_jax"))["vol"]
    assert sorted(got) == sorted(want) and len(got) == 2
    for seg_path, entry in got.items():
        g, w = entry["pred_errors"], want[seg_path]["pred_errors"]
        assert "voi" not in entry and g["total_voxels"] == 24 * 96 * 96
        gm = open_ds(g["error_map"]).to_ndarray()
        wm = JA.open_ds(w["error_map"]).to_ndarray()
        np.testing.assert_allclose(gm, wm, rtol=0, atol=ERR_ATOL)
        tie = (np.abs(wm - 0.1) <= ERR_ATOL) | (np.abs(wm - 1.0) <= ERR_ATOL)
        assert int(tie.sum()) == 0
        np.testing.assert_array_equal(open_ds(g["error_mask"]).to_ndarray(), JA.open_ds(w["error_mask"]).to_ndarray())
        assert g["nonzero_ratio"] == w["nonzero_ratio"]


NO_NETWORKX = """
import json, sys
sys.modules["networkx"] = None
sys.path.insert(0, sys.argv[1])
from bootstrapper_torch.workflows import run_evaluation, run_filter
from bootstrapper_torch.__main__ import main
gt, nogt, filt, out = sys.argv[2:6]
voi = run_evaluation(gt, out_result=out + "/gt.json", device="cpu")["vol"]
err = run_evaluation(nogt, out_result=out + "/nogt.json", device="cpu")["vol"]
res = run_filter(filt, num_workers=1, param_overrides=[
    "out_seg_dataset_prefix=" + repr(out + "/f.zarr/labels"),
    "out_mask_dataset_prefix=" + repr(out + "/f.zarr/mask"),
])
assert all("voi_sum" in e["voi"] for e in voi.values()), voi
assert all(0 <= e["pred_errors"]["nonzero_ratio"] <= 1 for e in err.values()), err
assert res["vol"]["removed_ids"] >= 0
assert "networkx" not in [m for m in sys.modules if sys.modules[m] is not None]
main(["doctor"])
"""


def test_workflows_run_without_networkx(round1, tmp_path):
    """With networkx blocked, the workflows import, score VOI and
    prediction errors and filter; the doctor reports networkx missing."""
    paths = round1["paths"]
    nogt = _no_gt_config(round1, tmp_path / "eval_nx")
    proc = subprocess.run(
        [sys.executable, "-c", NO_NETWORKX, ROOT, paths["evaluate"], nogt, paths["filter"], str(tmp_path)],
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    doctor = json.loads(proc.stdout.strip().splitlines()[-1])
    assert doctor["networkx"] is False
