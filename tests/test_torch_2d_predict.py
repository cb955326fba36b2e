"""The port's 2D prediction against the JAX package's, on the CPU in fp32
(uint8 outputs within +-1):

- the 2D ``Predictor`` (``adj_slices`` sections in, one out, tiles run
  ``batch_tiles`` at a time) with a batch of 3, so that the last batch is
  padded and its extra outputs dropped;
- ``run_prediction`` over the chain ``2d_mtlsd -> 3d_affs_from_2d_mtlsd``
  (a narrow 2d_mtlsd with numpy-seeded weights, the refiner with its
  shipped checkpoint) in both packages, from the TOML ``configs`` writes.
"""

import json

import jax.numpy as jnp
import numpy as np
import torch

from bootstrapper_torch import configs
from bootstrapper_torch.core import arrays as A
from bootstrapper_torch.models import Model, init_params_numpy, load_params, save_checkpoint
from bootstrapper_torch.predict.scan import Predictor, prepare_prediction_outputs
from bootstrapper_torch.utils import tomlio
from bootstrapper_torch.workflows import run_prediction
from bootstrapper_tpu.core.arrays import open_ds as jax_open_ds
from bootstrapper_tpu.models.model import Model as JModel
from bootstrapper_tpu.predict.scan import Predictor as JPredictor
from bootstrapper_tpu.predict.scan import prepare_prediction_outputs as jax_outputs
from bootstrapper_tpu.workflows import predict as jax_workflow
from test_torch_2d import net_config_2d

VOXEL = (40, 4, 4)


def _within_one(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_2d_predictor_matches_jax_within_one(tmp_path):
    """20 tiles of (1, 8, 8) from a (5, 16, 16) volume, 3 a batch: the
    seventh batch holds two and is padded with its last."""
    shape = (5, 16, 16)
    raw = A.prepare_ds(str(tmp_path / "v.zarr" / "raw"), shape, (0, 0, 0), VOXEL, np.uint8)
    raw[raw.roi] = np.random.default_rng(0).integers(0, 256, shape, dtype=np.uint8)
    nc = net_config_2d(shape_increase=[0, 0])
    params = init_params_numpy(nc, 1)

    jm = JModel(nc)
    jp = JPredictor(jm, params, VOXEL, batch_tiles=3, compute_dtype=jnp.float32)
    jraw = jax_open_ds(str(tmp_path / "v.zarr" / "raw"))
    jouts = jax_outputs(str(tmp_path / "jax.zarr"), jm, jraw.roi, VOXEL, predictor=jp)
    jstats = jp.predict(jraw, jouts)

    model = load_params(Model(nc, compute_dtype=torch.float32), params)
    p = Predictor(model, VOXEL, batch_tiles=3, device="cpu", compute_dtype=torch.float32)
    assert (p.input_tile, p.output_tile, p.batch_tiles) == ((3, 100, 100), (1, 8, 8), 3)
    outs = prepare_prediction_outputs(str(tmp_path / "port.zarr"), model, raw.roi, VOXEL, p)
    batches, forward = [], p.forward
    p.forward = lambda x: batches.append(tuple(x.shape)) or forward(x)
    stats = p.predict(raw, outs)
    assert stats["tiles"] == jstats["tiles"] == 20
    assert batches == [(3, 3, 100, 100, 1)] * 7
    for name in ("2d_lsds", "2d_affs"):
        got = outs[name].to_ndarray()
        assert got.shape == (6, *shape)
        _within_one(got, jouts[name].to_ndarray())
    assert Predictor(Model(nc), VOXEL, device="cpu").batch_tiles == 32  # the JAX default


class _JPredictor32(JPredictor):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, compute_dtype=jnp.float32, **kwargs)


NAMES = ["2d_mtlsd", "3d_affs_from_2d_mtlsd"]
OUTPUTS = {
    "2d_mtlsd/5": ["2d_lsds", "2d_affs"],
    "3d_affs_from_2d_mtlsd/20000--from--2d_mtlsd_5": ["3d_affs"],
}


def _chain(root):
    """A (4, 56, 56) raw volume, the two setups (a narrow 2d_mtlsd at
    iteration 5, the shipped refiner), and the predict TOML for them."""
    shape = (4, 56, 56)  # the refiner's smallest output tile: one tile, not streamed
    container = str(root / "v.zarr")
    raw = A.prepare_ds(f"{container}/raw", shape, (0, 0, 0), VOXEL, np.uint8)
    raw[raw.roi] = np.random.default_rng(2).integers(0, 255, shape, dtype=np.uint8)
    setup_dirs = configs.setup_models(NAMES, str(root / "setups"))
    nc = net_config_2d()
    with open(f"{setup_dirs[0]}/net_config.json", "w") as f:
        json.dump(nc, f)
    save_checkpoint(setup_dirs[0], init_params_numpy(nc, 1), 5)
    vols = {"v": {"raw_dataset": f"{container}/raw", "voxel_size": list(VOXEL), "output_container": container}}
    toml = str(root / "predict.toml")
    tomlio.dump({"predict": configs.create_prediction_configs(vols, setup_dirs, [5, 20000])}, toml)
    return container, toml, shape


def test_2d_chain_matches_jax(tmp_path_factory, monkeypatch):
    runs = {}
    monkeypatch.setattr(jax_workflow, "Predictor", _JPredictor32)
    for name in ("port", "jax"):
        container, toml, shape = _chain(tmp_path_factory.mktemp(name))
        if name == "port":
            stats = run_prediction(toml, device="cpu", compute_dtype=torch.float32)
        else:
            stats = jax_workflow.run_prediction(toml)
        opener = A.open_ds if name == "port" else jax_open_ds  # the JAX package writes compressed Zarr
        runs[name] = stats, {(p, o): opener(f"{container}/{p}/{o}").to_ndarray() for p, os_ in OUTPUTS.items() for o in os_}
    (pstats, pouts), (jstats, jouts) = runs["port"], runs["jax"]
    assert sorted(pstats) == sorted(jstats) == sorted(f"v/{p}" for p in OUTPUTS)
    assert pstats["v/2d_mtlsd/5"]["tiles"] == 4 and "steps_per_column" not in pstats["v/" + list(OUTPUTS)[1]]
    for key, got in pouts.items():
        assert got.shape == ((9 if key[1] == "3d_affs" else 6), *shape)
        _within_one(got, jouts[key])
    assert pouts[(list(OUTPUTS)[1], "3d_affs")].std() > 0
