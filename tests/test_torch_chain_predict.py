"""The port's chained prediction against the JAX package's: a narrow
``3d_lsd -> 3d_affs_from_3d_lsd`` chain with numpy-seeded weights through
both packages' ``run_prediction`` on a volume deep enough that both
stream every link (within +-1 uint8 per link); re-running one link with
``setup_id``; and ``_align_chain_inputs`` in the four cases of
``tests/test_chain_predict.py``.  Both packages build fp32 predictors."""

import json
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bootstrapper_torch import configs
from bootstrapper_torch.core import arrays as A
from bootstrapper_torch.models import init_params_numpy, save_checkpoint
from bootstrapper_torch.utils import tomlio
from bootstrapper_torch.workflows import run_prediction
from bootstrapper_torch.workflows.predict import _align_chain_inputs
from bootstrapper_tpu.core.arrays import open_ds as jax_open_ds
from bootstrapper_tpu.predict import zstream as jax_zstream
from bootstrapper_tpu.predict.scan import Predictor as JPredictor
from bootstrapper_tpu.workflows import predict as jax_workflow

VOXEL = (40, 4, 4)
SHAPE = (14, 24, 16)  # deeper than one tiled z pass (2): every link streams
# one level: the JAX package compiles each link's stream steps in seconds
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
NAMES = ["3d_lsd", "3d_affs_from_3d_lsd"]


class _JPredictor32(JPredictor):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, compute_dtype=jnp.float32, **kwargs)


class _JZStream32(jax_zstream.ZStreamPredictor):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, compute_dtype=jnp.float32, **kwargs)


def _chain(root):
    """The raw volume, the two narrow setups with seeded weights at
    iteration 5, and the predict TOML ``configs`` writes for them."""
    container = str(root / "v.zarr")
    raw = A.prepare_ds(f"{container}/raw", SHAPE, (0, 0, 0), VOXEL, np.uint8)
    raw[raw.roi] = np.random.default_rng(0).integers(0, 255, SHAPE, dtype=np.uint8)
    setup_dirs = configs.setup_models(NAMES, str(root / "setups"))
    for seed, d in enumerate(setup_dirs):
        with open(f"{d}/net_config.json") as f:
            nc = json.load(f)
        nc.update(TINY)
        with open(f"{d}/net_config.json", "w") as f:
            json.dump(nc, f)
        save_checkpoint(d, init_params_numpy(nc, seed + 1), 5)
    vols = {"v": {"raw_dataset": f"{container}/raw", "voxel_size": list(VOXEL), "output_container": container}}
    toml = str(root / "predict.toml")
    tomlio.dump({"predict": configs.create_prediction_configs(vols, setup_dirs, [5, 5])}, toml)
    return container, toml


OUTPUTS = {
    "3d_lsd/5": "3d_lsds",
    "3d_affs_from_3d_lsd/5--from--3d_lsd_5": "3d_affs",
}


@pytest.fixture(scope="module")
def chains(tmp_path_factory):
    runs = {}
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_workflow, "Predictor", _JPredictor32)
    mp.setattr(jax_zstream, "ZStreamPredictor", _JZStream32)
    try:
        for name in ("port", "jax"):
            root = tmp_path_factory.mktemp(name)
            container, toml = _chain(root)
            if name == "port":
                stats = run_prediction(toml, device="cpu", compute_dtype=torch.float32)
            else:
                stats = jax_workflow.run_prediction(toml)
            # the JAX package writes compressed Zarr, which only it reads
            opener = A.open_ds if name == "port" else jax_open_ds
            outs = {p: opener(f"{container}/{p}/{o}").to_ndarray() for p, o in OUTPUTS.items()}
            runs[name] = (stats, outs, container, toml)
    finally:
        mp.undo()
    return runs


def test_chain_matches_jax(chains):
    port, jax = chains["port"], chains["jax"]
    assert sorted(port[0]) == sorted(jax[0]) == sorted(f"v/{p}" for p in OUTPUTS)
    for key, stats in port[0].items():
        assert "steps_per_column" in stats and "steps_per_column" in jax[0][key]
        for k in ("tiles", "columns", "steps_per_column"):
            assert stats[k] == jax[0][key][k], (key, k)
    for p, o in OUTPUTS.items():
        a, b = port[1][p], jax[1][p]
        assert a.shape == b.shape == ((10 if o == "3d_lsds" else 9), *SHAPE) and a.dtype == np.uint8
        diff = np.abs(a.astype(int) - b.astype(int))
        assert diff.max() <= 1, p
        assert (diff != 0).mean() < 1e-2, p


def test_chain_setup_id_reruns_one_link(chains, tmp_path):
    """``setup_id`` re-runs the refiner alone from its configured inputs,
    which gives what the whole chain gave; a later link with no inputs
    raises."""
    _, outs, container, toml = chains["port"]
    cfg = tomlio.load(toml)
    link = cfg["predict"]["v"]["chain"][1]
    link["output_prefix"] = "rerun"
    tomlio.dump(cfg, str(tmp_path / "rerun.toml"))
    stats = run_prediction(str(tmp_path / "rerun.toml"), setup_id="_from_", device="cpu", compute_dtype=torch.float32)
    assert list(stats) == ["v/rerun"]
    got = A.open_ds(f"{container}/rerun/3d_affs").to_ndarray()
    np.testing.assert_array_equal(got, outs["3d_affs_from_3d_lsd/5--from--3d_lsd_5"])
    del link["input_datasets"]
    tomlio.dump(cfg, str(tmp_path / "no_inputs.toml"))
    with pytest.raises(ValueError, match="input_datasets"):
        run_prediction(str(tmp_path / "no_inputs.toml"), setup_id="_from_", device="cpu")


def _ds(tmp_path, name, channels=6):
    return A.prepare_ds(str(tmp_path / "v.zarr" / name), (channels, 4, 8, 8), (0, 0, 0), (1, 1, 1), np.float32)


def _model(inputs):
    return SimpleNamespace(net_config={"inputs": inputs})


def test_align_chain_inputs_reorders_by_name(tmp_path):
    lsds, affs = _ds(tmp_path, "2d_lsds"), _ds(tmp_path, "2d_affs")
    model = _model({"2d_lsds": {"dims": 6}, "2d_affs": {"dims": 6}})
    arrays, labels = _align_chain_inputs(
        model, [affs, lsds], [str(tmp_path / "v.zarr/2d_affs"), str(tmp_path / "v.zarr/2d_lsds")]
    )
    assert arrays[0] is lsds and arrays[1] is affs
    assert labels[0].endswith("2d_lsds")


def test_align_chain_inputs_rejects_wrong_widths(tmp_path):
    a, b = _ds(tmp_path, "a"), _ds(tmp_path, "b")
    model = _model({"3d_lsds": {"dims": 10}, "3d_affs": {"dims": 9}})
    with pytest.raises(ValueError, match="channel widths"):
        _align_chain_inputs(model, [a, b], [str(tmp_path / "v.zarr/a"), str(tmp_path / "v.zarr/b")])


def test_align_chain_inputs_selects_subset_by_name(tmp_path):
    lsds, affs = _ds(tmp_path, "2d_lsds"), _ds(tmp_path, "2d_affs")
    arrays, labels = _align_chain_inputs(
        _model({"2d_affs": {"dims": 6}}), [lsds, affs],
        [str(tmp_path / "v.zarr/2d_lsds"), str(tmp_path / "v.zarr/2d_affs")],
    )
    assert len(arrays) == 1 and arrays[0] is affs
    assert labels[0].endswith("2d_affs")


def test_align_chain_inputs_rejects_unmatchable_count(tmp_path):
    a, b = _ds(tmp_path, "x"), _ds(tmp_path, "y")
    with pytest.raises(ValueError, match="matched by name"):
        _align_chain_inputs(_model({"2d_affs": {"dims": 6}}), [a, b], [str(tmp_path / "v.zarr/x"), str(tmp_path / "v.zarr/y")])


def test_refiner_tiles_read_predictions_in_unit_range(tmp_path):
    """On the tiled route too, a refiner's uint8 prediction inputs enter
    the net as ``x / 255``, not scaled to [-1, 1]: one output tile at the
    volume's corner (too shallow to stream) against the model on the
    reflect-padded input by hand."""
    from bootstrapper_torch.models import Model, load_checkpoint, load_params

    container, toml = _chain(tmp_path)
    link = tomlio.load(toml)["predict"]["v"]["chain"][1]
    lsds = A.prepare_ds(f"{container}/3d_lsd/5/3d_lsds", (10, *SHAPE), (0, 0, 0), VOXEL, np.uint8)
    lsds[lsds.roi] = np.random.default_rng(1).integers(0, 256, (10, *SHAPE), dtype=np.uint8)
    model = load_params(Model.from_setup(link["setup_dir"], compute_dtype=torch.float32),
                        load_checkpoint(f"{link['setup_dir']}/model_checkpoint_5")).eval()
    nc = model.net_config
    stats = run_prediction(toml, setup_id="_from_", roi_offset=(0, 0, 0),
                           roi_shape=[o * v for o, v in zip(nc["output_shape"], VOXEL)],
                           device="cpu", compute_dtype=torch.float32)
    (s,) = stats.values()
    assert "steps_per_column" not in s and s["tiles"] == 1
    affs = A.open_ds(f"{container}/{link['output_prefix']}/3d_affs").to_ndarray()
    ctx = [(i - o) // 2 for i, o in zip(nc["input_shape"], nc["output_shape"])]
    x = np.pad(lsds.to_ndarray(), [(0, 0)] + [(c, c) for c in ctx], mode="reflect")
    x = x[(slice(None), *(slice(0, i) for i in nc["input_shape"]))]
    with torch.no_grad():
        y = model(torch.from_numpy(np.moveaxis(x, 0, -1)[None].astype(np.float32) / 255))["3d_affs"][0].numpy()
    want = np.round(np.clip(np.moveaxis(y, -1, 0), 0, 1) * 255)
    assert affs.shape == want.shape and np.abs(affs.astype(int) - want).max() <= 1
