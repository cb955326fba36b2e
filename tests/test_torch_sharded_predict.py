"""The port's batch-sharded ``ShardedPredictor`` on ``["cpu"] * 4``, four
logical devices of one CPU, against the JAX package's on four of the
virtual devices that ``tests/conftest.py`` forces, from the same numpy
parameters in fp32, and against the port's own one-device ``Predictor``.

Tolerances: the port's sharded run equals its ``Predictor`` at the same
tile bit for bit (each device runs the same forward on the same tile, the
JAX module's promise); against the JAX package, uint8 within +-1 on under
1e-3 of voxels, the bound of ``tests/test_torch_zstream_predict.py`` (two
frameworks sum the same products in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bootstrapper_torch.core import arrays as A
from bootstrapper_torch.models import Model, init_params_numpy, load_params
from bootstrapper_torch.models.zoo import get_net_config
from bootstrapper_torch.predict.scan import Predictor, prepare_prediction_outputs
from bootstrapper_torch.predict.sharded import ShardedPredictor
from bootstrapper_tpu.core.arrays import open_ds as jax_open_ds
from bootstrapper_tpu.models.model import Model as JModel
from bootstrapper_tpu.predict.scan import prepare_prediction_outputs as jax_outputs
from bootstrapper_tpu.predict.sharded import ShardedPredictor as JShardedPredictor

N_DEV = 4


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """This module's torch work on 2 CPU thread(s): the driver runs the
    tests in several worker processes at once, and torch's thread pools in
    all of them oversubscribe the cores (each op waits on threads that are
    not scheduled); restored after the module."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _net_3d():
    """``tests/test_sharded_predict.py``'s tiny 3D net."""
    nc = get_net_config("3d_affs")
    nc.update(
        num_fmaps=2,
        fmap_inc_factor=2,
        input_shape=[12, 48, 48],
        output_shape=[4, 8, 8],
        shape_increase=[0, 0, 0],
        downsample_factors=[[1, 2, 2]] * 2,
        kernel_size_down=[[[1, 3, 3], [1, 3, 3]], [[3, 3, 3], [3, 3, 3]], [[3, 3, 3], [3, 3, 3]]],
        kernel_size_up=[[[1, 3, 3], [1, 3, 3]], [[1, 3, 3], [1, 3, 3]]],
    )
    nc["outputs"] = {
        "3d_affs": {"dtype": "uint8", "dims": 3, "neighborhood": [[-1, 0, 0], [0, -1, 0], [0, 0, -1]],
                    "grow_boundary": 1}
    }
    return nc, "3d_affs", (1, 1, 1), (16, 40, 40)


def _net_2d():
    """``tests/test_sharded_predict.py::test_sharded_2d_stacked``'s net."""
    nc = get_net_config("2d_affs")
    nc.update(
        num_fmaps=2,
        fmap_inc_factor=2,
        input_shape=[24, 24],
        output_shape=[8, 8],
        shape_increase=[0, 0],
        downsample_factors=[[2, 2]],
        kernel_size_down=[[[3, 3], [3, 3]]] * 2,
        kernel_size_up=[[[3, 3], [3, 3]]],
    )
    nc["outputs"] = {"2d_affs": {"dtype": "uint8", "dims": 2, "neighborhood": [[-1, 0], [0, -1]], "grow_boundary": 1}}
    return nc, "2d_affs", (50, 8, 8), (8, 24, 24)


def _model(nc, params):
    return load_params(Model(nc, compute_dtype=torch.float32), params)


@pytest.mark.parametrize("net", [_net_3d, _net_2d], ids=["3d", "2d_stacked"])
def test_sharded_matches_predictor_and_jax(tmp_path, net):
    nc, head, vs, shape = net()
    params = init_params_numpy(nc, 0)
    raw = A.prepare_ds(str(tmp_path / "t.zarr" / "raw"), shape, (0, 0, 0), vs, np.uint8)
    raw[raw.roi] = np.random.default_rng(3).integers(0, 255, shape, dtype=np.uint8)

    def port(name, predictor, model):
        outs = prepare_prediction_outputs(str(tmp_path / f"{name}.zarr"), model, raw.roi, vs, predictor)
        return predictor.predict(raw, outs), outs[head].to_ndarray()

    model = _model(nc, params)
    sharded = ShardedPredictor(model, vs, devices=["cpu"] * N_DEV, compute_dtype=torch.float32)
    stats, got = port("sharded", sharded, model)
    one = _model(nc, params)
    _, want = port("one", Predictor(one, vs, batch_tiles=1, device="cpu", compute_dtype=torch.float32), one)
    np.testing.assert_array_equal(got, want)
    # every device holds a replica of its own, none of the caller's tensors
    own = {p.data_ptr() for p in model.parameters()}
    assert all(not own & {p.data_ptr() for p in lane.model.parameters()} for lane in sharded.lanes)

    jm = JModel(nc)
    jsp = JShardedPredictor(jm, params, vs, devices=jax.devices()[:N_DEV], compute_dtype=jnp.float32)
    assert (jsp.in_tile, jsp.out_tile) == (sharded.input_tile, sharded.output_tile)
    jraw = jax_open_ds(raw.path)
    jouts = jax_outputs(str(tmp_path / "jax.zarr"), jm, jraw.roi, vs, predictor=jsp)
    jstats = jsp.predict(jraw, jouts)
    assert (stats["tiles"], stats["devices"]) == (jstats["tiles"], jstats["devices"]) == (stats["tiles"], N_DEV)
    assert stats["launches_by_device"] == [0] * N_DEV  # the CPU runs the plain version
    want = jouts[head].to_ndarray()
    diff = np.abs(got.astype(int) - want.astype(int))
    assert got.shape == want.shape and diff.max() <= 1 and (diff != 0).mean() < 1e-3


def test_short_last_batch_is_padded(tmp_path):
    """Five tiles over four devices: the last step pads with its last tile,
    whose extra outputs are not written (every device still runs)."""
    nc, head, vs, _ = _net_3d()
    shape = (20, 8, 8)  # five tiles in z
    raw = A.prepare_ds(str(tmp_path / "t.zarr" / "raw"), shape, (0, 0, 0), vs, np.uint8)
    raw[raw.roi] = np.random.default_rng(5).integers(0, 255, shape, dtype=np.uint8)
    params = init_params_numpy(nc, 1)
    model = _model(nc, params)
    sharded = ShardedPredictor(model, vs, devices="cpu,cpu,cpu,cpu", compute_dtype=torch.float32)
    outs = prepare_prediction_outputs(str(tmp_path / "s.zarr"), model, raw.roi, vs, sharded)
    assert sharded.predict(raw, outs)["tiles"] == 5
    one = _model(nc, params)
    pred = Predictor(one, vs, device="cpu", compute_dtype=torch.float32)
    ref = prepare_prediction_outputs(str(tmp_path / "o.zarr"), one, raw.roi, vs, pred)
    pred.predict(raw, ref)
    np.testing.assert_array_equal(outs[head].to_ndarray(), ref[head].to_ndarray())


def test_2d_int8_sharded_matches_jax(tmp_path, monkeypatch):
    """A 2D setup under ``BS_INT8=1`` over two logical devices, one section
    each: each scale over both devices' sections, so the affinities equal
    the one-device run two sections a batch (uint8 for uint8) and the JAX
    package's ``ShardedPredictor`` on two virtual devices within the int8
    bound of ``tests/test_torch_quant.py`` (+-1 on under 1% of voxels)."""
    monkeypatch.setenv("BS_INT8", "1")
    nc, head, vs, shape = _net_2d()
    params = init_params_numpy(nc, 0)
    raw = A.prepare_ds(str(tmp_path / "t.zarr" / "raw"), shape, (0, 0, 0), vs, np.uint8)
    raw[raw.roi] = np.random.default_rng(8).integers(0, 255, shape, dtype=np.uint8)

    def port(name, predictor, model):
        outs = prepare_prediction_outputs(str(tmp_path / f"{name}.zarr"), model, raw.roi, vs, predictor)
        predictor.predict(raw, outs)
        return outs[head].to_ndarray()

    model = _model(nc, params)
    got = port("sharded", ShardedPredictor(model, vs, devices=["cpu"] * 2, compute_dtype=torch.float32), model)
    one = _model(nc, params)
    pair = port("pair", Predictor(one, vs, batch_tiles=2, device="cpu", compute_dtype=torch.float32), one)
    np.testing.assert_array_equal(got, pair)

    jm = JModel(nc)
    jsp = JShardedPredictor(jm, params, vs, devices=jax.devices()[:2], compute_dtype=jnp.float32)
    jraw = jax_open_ds(raw.path)
    jouts = jax_outputs(str(tmp_path / "jax.zarr"), jm, jraw.roi, vs, predictor=jsp)
    jsp.predict(jraw, jouts)
    want = jouts[head].to_ndarray()
    diff = np.abs(got.astype(int) - want.astype(int))
    assert got.shape == want.shape and diff.max() <= 1 and (diff != 0).mean() < 1e-2


def test_a_failing_int8_lane_raises_and_frees_the_others(monkeypatch):
    """Under ``BS_INT8=1`` the lanes wait for each other at every
    quantization point: a lane that fails releases the others' waits, and
    its error is raised (no lane is left waiting)."""
    from bootstrapper_torch.predict._pipeline import Lane, dispatch_lanes
    from bootstrapper_torch.predict.scan import forward_uint8

    monkeypatch.setenv("BS_INT8", "1")
    nc, _, _, _ = _net_3d()
    model = _model(nc, init_params_numpy(nc, 0))
    lanes = [Lane(model, torch.device("cpu"), torch.float32) for _ in range(2)]
    x = np.zeros((1, *nc["input_shape"], 1), np.uint8)

    def fails(_):
        raise RuntimeError("this lane failed")

    with pytest.raises(RuntimeError, match="this lane failed"):
        dispatch_lanes(lanes, [x, x], [lambda t: forward_uint8(lanes[0].model, t, True), fails], [0, 0])
