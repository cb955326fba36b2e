"""The port's ``ZStreamPredictor`` and ``run_prediction``'s route on the
CPU, through Zarr, against the port's tiled ``Predictor`` and the JAX
package (fp32 on both sides).

uint8 outputs must agree within +-1 with under 1e-3 of voxels differing,
the bound of the JAX package's own ``tests/test_zstream_predict.py``: the
stream and the tiles sum the same products in another order, so a value
on a rounding boundary may land one step apart.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bootstrapper_torch.core import arrays as A
from bootstrapper_torch.models import Model, init_params_numpy, load_params, save_checkpoint
from bootstrapper_torch.models.zoo import get_net_config
from bootstrapper_torch.predict._pipeline import PinnedBuffers
from bootstrapper_torch.predict.scan import Predictor, prepare_prediction_outputs
from bootstrapper_torch.predict.zstream import ZStreamPredictor
from bootstrapper_torch.utils import tomlio
from bootstrapper_torch.workflows import run_prediction
from bootstrapper_tpu.core.arrays import open_ds as jax_open_ds
from bootstrapper_tpu.models.model import Model as JModel
from bootstrapper_tpu.predict import zstream as jax_zstream
from bootstrapper_tpu.predict.scan import Predictor as JPredictor
from bootstrapper_tpu.predict.scan import prepare_prediction_outputs as jax_outputs
from bootstrapper_tpu.workflows import predict as jax_workflow

VOXEL = (40, 4, 4)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """This module's torch work on 2 CPU thread(s): the test run uses
    six worker processes at once, and torch's thread pools in all
    of them oversubscribe the cores (each op waits on threads that are not
    scheduled); restored after the module."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _net_config(num_fmaps=2, inc=2):
    """``tests/test_zstream_predict.py``'s tiny 3d_affs net (3 heads, z
    context 20, tile (24,48,48) -> (4,8,8)); ``inc`` 6 with 4 fmaps puts
    its 144-channel convs on the kernel route."""
    nc = get_net_config("3d_affs")
    nc.update(
        num_fmaps=num_fmaps,
        fmap_inc_factor=inc,
        input_shape=[24, 48, 48],
        output_shape=[4, 8, 8],
        shape_increase=[0, 0, 0],
        downsample_factors=[[1, 2, 2]] * 2,
        kernel_size_down=[[[3, 3, 3], [3, 3, 3]]] * 3,
        kernel_size_up=[[[3, 3, 3], [3, 3, 3]]] * 2,
    )
    nc["outputs"] = {
        "3d_affs": {
            "dtype": "uint8",
            "dims": 3,
            "neighborhood": [[-1, 0, 0], [0, -1, 0], [0, 0, -1]],
            "grow_boundary": 1,
        }
    }
    return nc


def _model(nc, params):
    return load_params(Model(nc, compute_dtype=torch.float32), params)


def _raw(path, shape, seed):
    ds = A.prepare_ds(path, shape, (0, 0, 0), VOXEL, np.uint8)
    ds[ds.roi] = np.random.default_rng(seed).integers(0, 255, shape, dtype=np.uint8)
    return ds


def _assert_quant_equal(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
    diff = np.abs(a.astype(int) - b.astype(int))
    assert diff.max() <= 1
    assert (diff != 0).mean() < 1e-3


def _chunks(path):
    with open(f"{path}/.zarray") as f:
        return tuple(json.load(f)["chunks"])


def _port_predict(tmp_path, name, predictor, model, raw):
    outs = prepare_prediction_outputs(str(tmp_path / f"{name}.zarr"), model, raw.roi, VOXEL, predictor)
    stats = predictor.predict(raw, outs)
    return stats, outs["3d_affs"]


@pytest.mark.parametrize(
    "net,depth,step_z,warm_step_z",
    [
        ("narrow", 20, None, None),  # an exact multiple of the step
        ("narrow", 22, None, None),  # a clipped remainder
        ("narrow", 21, 7, None),  # a free step
        ("narrow", 23, 5, 1),  # a small warm step
        ("wide", 22, 3, 2),
    ],
)
def test_zstream_matches_tiled_and_jax(tmp_path, net, depth, step_z, warm_step_z):
    nc = _net_config() if net == "narrow" else _net_config(4, 6)
    params = init_params_numpy(nc, 0)
    shape = (depth, 60, 40)  # 8 x 5 xy columns (the last row shifted in), deep in z
    raw = _raw(str(tmp_path / "t.zarr" / "raw"), shape, depth)

    tiled_model = _model(nc, params)
    tiled = Predictor(tiled_model, VOXEL, device="cpu", compute_dtype=torch.float32)
    _, want = _port_predict(tmp_path, "tiled", tiled, tiled_model, raw)

    model = _model(nc, params)
    zp = ZStreamPredictor(
        model, VOXEL, device="cpu", compute_dtype=torch.float32,
        step_z=step_z, warm_step_z=warm_step_z,
    )
    stats, got = _port_predict(tmp_path, "stream", zp, model, raw)
    s, s_warm = zp.s, zp.s_warm
    assert (s, s_warm) == (step_z or 4, warm_step_z or s)
    assert stats["steps_per_column"] == 1 + -(-(depth - s_warm) // s)
    assert stats["columns"] == 8 * 5 and stats["z_segments"] == 1
    assert stats["tiles"] == 8 * 5 * stats["steps_per_column"]
    assert _chunks(got.path) == (3, np.gcd(s, s_warm), 8, 8)
    _assert_quant_equal(got.to_ndarray(), want.to_ndarray())

    jm = JModel(nc)
    jzp = jax_zstream.ZStreamPredictor(
        jm, params, VOXEL, compute_dtype=jnp.float32, step_z=step_z, warm_step_z=warm_step_z
    )
    jraw = jax_open_ds(raw.path)
    jouts = jax_outputs(str(tmp_path / "jax.zarr"), jm, jraw.roi, VOXEL, predictor=jzp)
    jstats = jzp.predict(jraw, jouts)
    for key in ("tiles", "columns", "steps_per_column", "z_segments"):
        assert stats[key] == jstats[key]
    assert _chunks(jouts["3d_affs"].path) == _chunks(got.path)
    _assert_quant_equal(got.to_ndarray(), jouts["3d_affs"].to_ndarray())


def test_zstream_rejects_z_pooling_nets():
    nc = _net_config()
    nc.update(downsample_factors=[[2, 2, 2], [1, 2, 2]], input_shape=[32, 48, 48])
    with pytest.raises(ValueError, match="never downsamples z"):
        ZStreamPredictor(Model(nc), VOXEL, device="cpu")
    with pytest.raises(ValueError):
        jax_zstream.ZStreamPredictor(JModel(nc), {}, VOXEL)


def test_zstream_rejects_off_grid_tiles():
    with pytest.raises(ValueError, match="pooling grid"):
        ZStreamPredictor(Model(_net_config()), VOXEL, shape_increase=[0, 2, 2], device="cpu")
    with pytest.raises(ValueError, match="warm_step_z"):
        ZStreamPredictor(Model(_net_config()), VOXEL, step_z=3, warm_step_z=4, device="cpu")


def test_read_z_reflect_reflects_about_the_volume(tmp_path):
    """A last step's read overhangs the volume end by more than it holds:
    it must be the volume reflected about its last slice."""
    raw = _raw(str(tmp_path / "t.zarr" / "raw"), (6, 8, 8), 0)
    zp = ZStreamPredictor(Model(_net_config()), VOXEL, device="cpu", step_z=1)
    vol = raw.to_ndarray()
    full = np.pad(vol, [(6, 6), (0, 0), (0, 0)], mode="reflect")
    for z0, nz in [(4, 4), (6, 3), (7, 2), (-3, 2), (-2, 5)]:
        roi = A.Roi((z0 * 40, 0, 0), (nz * 40, 32, 32))
        np.testing.assert_array_equal(zp._read_z_reflect(raw, roi), full[6 + z0 : 6 + z0 + nz])


class _JPredictor32(JPredictor):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, compute_dtype=jnp.float32, **kwargs)


class _JZStream32(jax_zstream.ZStreamPredictor):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, compute_dtype=jnp.float32, **kwargs)


@pytest.mark.parametrize(
    "shape,opt_out,streams",
    [
        ((14, 24, 16), False, True),  # deeper than one tiled pass: a stream
        ((4, 24, 16), False, False),  # one tiled pass deep: tiles
        ((14, 24, 16), True, False),  # BS_ZSTREAM=0: tiles
    ],
)
def test_run_prediction_route_matches_jax(tmp_path, monkeypatch, shape, opt_out, streams):
    """The same TOML through both packages' ``run_prediction``: the same
    route (a stream's stats carry ``steps_per_column``), the same counts,
    and affinities within +-1.  The JAX workflow builds its predictors in
    fp32 here (its entry point has no dtype argument)."""
    monkeypatch.setattr(jax_workflow, "Predictor", _JPredictor32)
    monkeypatch.setattr(jax_zstream, "ZStreamPredictor", _JZStream32)
    if opt_out:
        monkeypatch.setenv("BS_ZSTREAM", "0")
    nc = _net_config()
    setup = tmp_path / "setup"
    setup.mkdir()
    with open(setup / "net_config.json", "w") as f:
        json.dump(nc, f)
    save_checkpoint(str(setup), init_params_numpy(nc, 3), 1)
    raw = _raw(str(tmp_path / "t.zarr" / "raw"), shape, 1)
    runs = {}
    for name in ("port", "jax"):
        toml = str(tmp_path / f"{name}.toml")
        tomlio.dump(
            {"predict": {"v": {
                "raw_dataset": raw.path,
                "output_container": str(tmp_path / f"{name}.zarr"),
                "chain": [{"setup_dir": str(setup), "output_prefix": "pred"}],
            }}},
            toml,
        )
        if name == "port":
            stats = run_prediction(toml, device="cpu", compute_dtype=torch.float32)
        else:
            stats = jax_workflow.run_prediction(toml)
        affs = str(tmp_path / f"{name}.zarr" / "pred" / "3d_affs")
        # the JAX package writes compressed Zarr, which only it reads
        runs[name] = (stats["v/pred"], affs, (A.open_ds if name == "port" else jax_open_ds)(affs))
    (port, port_path, port_affs), (jax, jax_path, jax_affs) = runs["port"], runs["jax"]
    assert ("steps_per_column" in port) == ("steps_per_column" in jax) == streams
    for key in ("tiles", "columns", "steps_per_column"):
        assert port.get(key) == jax.get(key)
    assert _chunks(port_path) == _chunks(jax_path)
    _assert_quant_equal(port_affs.to_ndarray(), jax_affs.to_ndarray())


def test_pinned_buffers_keyed_by_shape():
    """A stream's warm and steady steps alternate two shapes: each keeps
    its own buffer, made once."""
    bufs = PinnedBuffers(pin=False)
    warm = bufs.get("in", (1, 24, 48, 48, 1), torch.uint8)
    steady = bufs.get("in", (1, 4, 48, 48, 1), torch.uint8)
    assert warm.shape == (1, 24, 48, 48, 1) and steady.shape == (1, 4, 48, 48, 1)
    for _ in range(3):
        assert bufs.get("in", (1, 24, 48, 48, 1), torch.uint8) is warm
        assert bufs.get("in", (1, 4, 48, 48, 1), torch.uint8) is steady
    assert bufs.get("in", (1, 4, 48, 48, 1), torch.float32) is not steady
    assert bufs.get("3d_affs", (1, 4, 48, 48, 1), torch.uint8) is not steady
    assert len(bufs._bufs) == 4


def test_tile_outputs_depend_on_the_xy_edge_only_near_it():
    """Why a stream and a tiled prediction with another xy tile differ at
    the tiled seams: a tile's outputs within a few voxels of its xy edge
    depend on where the edge lies (the trilinear upsample clamps there),
    and nowhere else.  A (29,140,140) input against a (29,204,204) one
    whose corner it is, in fp32: equal (float noise) from 5 voxels off the
    small tile's far edges, not at the edge itself."""
    nc = get_net_config("3d_affs")
    nc.update(num_fmaps=4, fmap_inc_factor=6)
    model = _model(nc, init_params_numpy(nc, 0)).eval()
    wide = np.random.default_rng(0).uniform(-1, 1, (1, 29, 204, 204, 1)).astype(np.float32)
    with torch.no_grad():
        small = model(torch.from_numpy(wide[:, :, :140, :140]))["3d_affs"][0, 0].numpy()
        big = model(torch.from_numpy(wide))["3d_affs"][0, 0].numpy()
    diff = np.abs(small - big[: small.shape[0], : small.shape[1]]).max(-1)
    h, w = diff.shape
    to_edge = np.minimum(h - 1 - np.arange(h)[:, None], w - 1 - np.arange(w)[None, :])
    assert diff[to_edge >= 5].max() < 2e-6
    assert diff[to_edge == 0].max() > 1e-5
