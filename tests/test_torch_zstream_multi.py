"""Lockstep z streaming over several logical devices (``["cpu"] * n``)
against the JAX package's over the virtual devices that
``tests/conftest.py`` forces, from the same numpy parameters in fp32, and
``plan_z_groups`` against the JAX function.

Tolerances: uint8 within +-1 on under 1e-3 of voxels, the bound of
``tests/test_zstream_predict.py`` (a step's graph sums in another order
than a tile's); against the port's one-device stream at the same plan, bit
for bit (each column runs the same steps on its own device).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bootstrapper_torch.core import arrays as A
from bootstrapper_torch.models import Model, init_params_numpy, load_params
from bootstrapper_torch.models.zoo import get_net_config
from bootstrapper_torch.predict import zstream as Z
from bootstrapper_torch.predict.scan import prepare_prediction_outputs
from bootstrapper_tpu.core.arrays import open_ds as jax_open_ds
from bootstrapper_tpu.models.model import Model as JModel
from bootstrapper_tpu.predict import zstream as JZ
from bootstrapper_tpu.predict.scan import prepare_prediction_outputs as jax_outputs

VS = (40, 4, 4)
JAX_WARM_COST_FACTOR = JZ.WARM_COST_FACTOR


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


def _net():
    """``tests/test_zstream_predict.py``'s tiny net (z context 20)."""
    nc = get_net_config("3d_affs")
    nc.update(
        num_fmaps=2,
        fmap_inc_factor=2,
        input_shape=[24, 48, 48],
        output_shape=[4, 8, 8],
        shape_increase=[0, 0, 0],
        downsample_factors=[[1, 2, 2]] * 2,
        kernel_size_down=[[[3, 3, 3], [3, 3, 3]]] * 3,
        kernel_size_up=[[[3, 3, 3], [3, 3, 3]]] * 2,
    )
    nc["outputs"] = {
        "3d_affs": {"dtype": "uint8", "dims": 3, "neighborhood": [[-1, 0, 0], [0, -1, 0], [0, 0, -1]],
                    "grow_boundary": 1}
    }
    return nc


GROUP_CASES = [  # tests/test_zstream_predict.py::test_plan_z_groups_cost_model's, then others
    (2000, 2, 8, 24, 4, 28), (2000, 8, 8, 24, 4, 28), (2000, 9, 8, 24, 4, 28), (130, 1, 8, 24, 4, 28),
    (2000, 1, 1, 24, 4, 28), (22, 15, 4, 4, 4, 20), (36, 2, 8, 4, 4, 20), (38, 2, 8, 4, 4, 20),
    (130, 1, 2, 64, 4, 28), (1200, 3, 4, 64, 4, 28), (64, 1, 2, 24, 4, 28), (5, 1, 8, 4, 1, 20),
]


@pytest.mark.parametrize("factor", [JAX_WARM_COST_FACTOR, Z.WARM_COST_FACTOR], ids=["jax_factor", "port_factor"])
def test_plan_z_groups_matches_jax(factor):
    cases = list(GROUP_CASES)
    rng = np.random.default_rng(0)
    for _ in range(60):
        s_warm = int(rng.integers(1, 9))
        cases.append((int(rng.integers(1, 3000)), int(rng.integers(1, 20)), int(rng.integers(1, 9)),
                      s_warm * int(rng.integers(1, 17)), s_warm, int(rng.integers(0, 40))))
    for case in cases:
        got = Z.plan_z_groups(*case, warm_cost_factor=factor)
        want = JZ.plan_z_groups(*case, warm_cost_factor=factor)
        assert got[:2] == want[:2] and got[2] == pytest.approx(want[2], rel=1e-12), case


def _raw(path, shape, seed):
    ds = A.prepare_ds(path, shape, (0, 0, 0), VS, np.uint8)
    ds[ds.roi] = np.random.default_rng(seed).integers(0, 255, shape, dtype=np.uint8)
    return ds


@pytest.mark.parametrize(
    "shape,n_dev,seed",
    [
        ((22, 24, 40), 4, 1),  # 3x5 = 15 xy columns: a short last group, a z remainder
        ((38, 8, 16), 8, 4),  # 2 columns over 8 devices: z segments, a ragged last one
    ],
    ids=["15_columns_4_devices", "2_columns_8_devices"],
)
def test_lockstep_stream_matches_jax_and_one_device(tmp_path, shape, n_dev, seed):
    nc = _net()
    params = init_params_numpy(nc, 0)
    raw = _raw(str(tmp_path / "t.zarr" / "raw"), shape, seed)

    def port(name, **kw):
        model = load_params(Model(nc, compute_dtype=torch.float32), params)
        zp = Z.ZStreamPredictor(model, VS, compute_dtype=torch.float32, **kw)
        outs = prepare_prediction_outputs(str(tmp_path / f"{name}.zarr"), model, raw.roi, VS, zp)
        return zp.predict(raw, outs), outs["3d_affs"].to_ndarray()

    stats, got = port("lockstep", devices=["cpu"] * n_dev)
    columns = -(-shape[1] // 8) * -(-shape[2] // 8)
    g, _, _ = Z.plan_z_groups(shape[0], columns, n_dev, 4, 4, 20)
    assert (stats["devices"], stats["columns"], stats["z_segments"]) == (n_dev, columns, g)
    assert stats["tiles"] == columns * g * stats["steps_per_column"]
    if n_dev == 8:
        assert g > 1  # the devices were filled by splitting z
    else:
        assert columns * g % n_dev  # a short last group
    _, one = port("one", device="cpu")
    np.testing.assert_array_equal(got, one)

    jm = JModel(nc)
    jzp = JZ.ZStreamPredictor(jm, params, VS, compute_dtype=jnp.float32, devices=jax.devices()[:n_dev])
    jraw = jax_open_ds(raw.path)
    jouts = jax_outputs(str(tmp_path / "jax.zarr"), jm, jraw.roi, VS, predictor=jzp)
    jstats = jzp.predict(jraw, jouts)
    assert (jstats["devices"], jstats["columns"]) == (n_dev, columns)
    want = jouts["3d_affs"].to_ndarray()
    diff = np.abs(got.astype(int) - want.astype(int))
    assert got.shape == want.shape and diff.max() <= 1 and (diff != 0).mean() < 1e-3


def test_lockstep_int8_shares_scales_and_matches_jax(tmp_path, monkeypatch):
    """Lockstep streams over two logical devices under ``BS_INT8=1``: every
    column of a step quantizes each conv-pass input with one scale over
    both columns (the recorder: bit-equal across lanes and equal to ``max(lane
    amaxes) / 127``), as the JAX package's step over the sharded column
    batch takes it; the affinities within the int8 bound of
    ``tests/test_torch_quant.py`` (+-1 on under 1% of voxels) of the JAX
    lockstep stream on two virtual devices, on that module's volume and net
    (10 xy columns of it).

    The bound is the jitted graph's: XLA puts some values a rounding step
    from where the JAX package's op-by-op graph puts them (that module's
    docstring), and on a (22, 16, 16) volume from seed 6 its lockstep stream
    stands 2 apart on 4.3% of voxels, where the port equals the JAX
    package's op-by-op lockstep stream (``jax.disable_jit``) voxel for
    voxel; that run takes about a minute on the CPU, too long for here."""
    from bootstrapper_torch.core.geometry import Roi
    from bootstrapper_torch.ops import quant as Q
    from bootstrapper_tpu.core.geometry import Roi as JRoi

    monkeypatch.setenv("BS_INT8", "1")
    nc = _net()
    params = init_params_numpy(nc, 0)
    vs = (40, 4, 4)
    shape = (22, 60, 40)
    raw = A.prepare_ds(str(tmp_path / "v.zarr" / "raw"), shape, (0, 0, 0), vs, np.uint8)
    raw[raw.roi] = np.random.default_rng(22).integers(0, 255, shape, dtype=np.uint8)
    roi = ((0, 0, 0), (22 * vs[0], 16 * vs[1], 40 * vs[2]))
    model = load_params(Model(nc, compute_dtype=torch.float32), params)
    zp = Z.ZStreamPredictor(model, vs, compute_dtype=torch.float32, devices=["cpu", "cpu"])
    outs = prepare_prediction_outputs(str(tmp_path / "q.zarr"), model, Roi(*roi), vs, zp)
    with Q.record_scales() as groups:
        stats = zp.predict(raw, outs, Roi(*roi))
    got = outs["3d_affs"].to_ndarray()
    assert stats["columns"] == 10 and len(groups) == stats["tiles"] // 2
    for g in groups:
        assert g.plain[0] == g.plain[1] > 0
        for amaxes, scales in g.scales():
            assert scales[0] == scales[1] == Q.shared_scale(amaxes)

    jm = JModel(nc)
    jzp = JZ.ZStreamPredictor(jm, params, vs, compute_dtype=jnp.float32, devices=jax.devices()[:2])
    jraw = jax_open_ds(raw.path)
    jouts = jax_outputs(str(tmp_path / "jax.zarr"), jm, JRoi(*roi), vs, predictor=jzp)
    jzp.predict(jraw, jouts, JRoi(*roi))
    want = jouts["3d_affs"].to_ndarray()
    diff = np.abs(got.astype(int) - want.astype(int))
    assert got.shape == want.shape and diff.max() <= 1 and (diff != 0).mean() < 1e-2
