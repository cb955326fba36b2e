"""The port's spatially sharded ``SpatialShardedPredictor`` on ``["cpu"] *
n`` logical devices against the JAX package's ``predict/spatial.py`` on
the virtual devices that ``tests/conftest.py`` forces, from the same numpy
parameters in fp32.

Tolerances, as ``tests/test_spatial_predict.py`` holds the JAX module: a
slab's output equals the forward of a tile the slab's size (bit for bit in
the port, +-1 against the JAX package: two frameworks sum in another
order); against the whole tile's forward, 0 further than 4 rows from a
slab seam and, within them, where the trilinear upsample clamps at the
slab's edge, apart as the JAX package's split tile is from its whole one
(within +-1 of its differences; 2 on the JAX test's float input, 3 on the
uint8 input here, in both packages).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bootstrapper_torch.core import arrays as A
from bootstrapper_torch.models import Model, init_params_numpy, load_params
from bootstrapper_torch.models.model import unet_config
from bootstrapper_torch.models.zoo import get_net_config
from bootstrapper_torch.predict import spatial as S
from bootstrapper_torch.predict.scan import Predictor, prepare_prediction_outputs
from bootstrapper_tpu.core.arrays import open_ds as jax_open_ds
from bootstrapper_tpu.models.model import Model as JModel
from bootstrapper_tpu.predict.scan import prepare_prediction_outputs as jax_outputs
from bootstrapper_tpu.predict import spatial as JS

VS = (1, 1, 1)


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


def _tiny():
    """``tests/test_spatial_predict.py``'s tiny 3D net."""
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
    return nc


def _pooled_z():
    nc = _tiny()
    nc.update(downsample_factors=[[2, 2, 2], [1, 2, 2]], input_shape=[24, 48, 48], output_shape=[4, 8, 8])
    return nc


NETS = {"tiny": _tiny, "pooled_z": _pooled_z, "3d_affs": lambda: get_net_config("3d_affs"),
        "2d_mtlsd": lambda: get_net_config("2d_mtlsd")}


@pytest.mark.parametrize("net", sorted(NETS))
def test_slab_rules_match_jax(net):
    """``slab_is_valid``, ``pick_shard_axis`` and ``spatial_shape_increase``
    give the JAX package's answers over a grid of tiles and 1-8 devices."""
    nc = NETS[net]()
    cfg, jcfg = unet_config(nc), JModel(nc).unet_config
    dims = len(nc["input_shape"])
    steps = [int(np.prod([f[d] for f in nc["downsample_factors"]])) for d in range(dims)]
    for k in range(4):
        inc = [k * st * (1 + d) for d, st in enumerate(steps)]
        in_tile = [a + b for a, b in zip(nc["input_shape"], inc)]
        out_tile = [a + b for a, b in zip(nc["output_shape"], inc)]
        ctx = [(i - o) // 2 for i, o in zip(in_tile, out_tile)]
        for n in range(1, 9):
            for d in range(dims):
                assert S.slab_is_valid(cfg, in_tile, out_tile, d, n) == JS.slab_is_valid(jcfg, in_tile, out_tile, d, n)
            for with_cfg in (False, True):
                kw = dict(unet_cfg=cfg, in_tile=in_tile) if with_cfg else {}
                jkw = dict(unet_cfg=jcfg, in_tile=in_tile) if with_cfg else {}
                try:
                    want = JS.pick_shard_axis(out_tile, ctx, n, **jkw)
                except ValueError:
                    with pytest.raises(ValueError, match="valid slabs"):
                        S.pick_shard_axis(out_tile, ctx, n, **kw)
                else:
                    assert S.pick_shard_axis(out_tile, ctx, n, **kw) == want
    for n in range(1, 9):
        for vol in (None, [400, 2000, 2000], [40, 300, 300]):
            try:
                want = JS.spatial_shape_increase(nc, n, vol)
            except ValueError:
                with pytest.raises(ValueError, match="valid slabs"):
                    S.spatial_shape_increase(nc, n, vol)
            else:
                assert S.spatial_shape_increase(nc, n, vol) == want


@pytest.fixture(scope="module")
def tiny_pair():
    nc = _tiny()
    return nc, init_params_numpy(nc, 0)


def _model(nc, params):
    return load_params(Model(nc, compute_dtype=torch.float32), params)


def test_split_tile_matches_slab_forwards_and_jax(tiny_pair):
    """(12,152,48) -> (4,112,8) over four devices: y splits into slabs of
    28 rows with 20 of context, so the halos take a whole-slab hop each
    way."""
    nc, params = tiny_pair
    n = 4
    sp = S.SpatialShardedPredictor(
        _model(nc, params), VS, devices=["cpu"] * n, shape_increase=[0, 104, 0], compute_dtype=torch.float32
    )
    jsp = JS.SpatialShardedPredictor(
        JModel(nc), params, VS, devices=jax.devices()[:n], shape_increase=[0, 104, 0], compute_dtype=jnp.float32
    )
    assert (sp.in_tile, sp.out_tile) == ((12, 152, 48), (4, 112, 8)) == (jsp.in_tile, jsp.out_tile)
    assert sp.shard_axis == jsp.shard_axis == 1
    assert (sp.hops, sp.halo, sp.in_padded) == (jsp.hops, jsp.halo, jsp.in_padded) and sp.hops[0] >= 1

    x = np.random.default_rng(1).integers(0, 255, (12, sp.in_padded, 48, 1), dtype=np.uint8)
    got = sp.gather(sp.dispatch(x))["3d_affs"]
    assert got.shape == (1, 4, 112, 8, 3)
    bytes_per_slab = 12 * sp.c_in * 48
    assert sp.halo_bytes == bytes_per_slab * sum(sp.hops) * (n - 1)

    # each slab: the forward of a tile the slab's size, at its place
    one = Predictor(_model(nc, params), VS, shape_increase=[0, 20, 0], device="cpu", compute_dtype=torch.float32)
    own, rows = sp.own_out, sp.slab_rows
    slabs = [one.forward(torch.from_numpy(x[None, :, k * own : k * own + rows]))["3d_affs"] for k in range(n)]
    np.testing.assert_array_equal(got, torch.cat(slabs, dim=2).numpy())

    want = np.asarray(jsp._forward(jsp.params, jnp.asarray(x[None]))["3d_affs"])
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1

    # the whole tile's forward: apart only within the upsample's reach of a
    # seam, and there as the JAX package's split tile is apart from its whole
    # one (on this uint8 input both read 3 at the seams; the JAX test's float
    # input reads 2)
    whole = Predictor(_model(nc, params), VS, shape_increase=[0, 104, 0], device="cpu", compute_dtype=torch.float32)
    ref = whole.forward(torch.from_numpy(x[None, :, : sp.in_tile[1]]))["3d_affs"].numpy()
    diff = np.abs(ref.astype(int) - got.astype(int))
    jm = JModel(nc, compute_dtype=jnp.float32)
    jref = jm.apply(jsp.params, jnp.asarray(x[None, :, : sp.in_tile[1]], jnp.float32) / 255.0 * 2.0 - 1.0)["3d_affs"]
    jdiff = np.abs(np.round(np.clip(np.asarray(jref), 0, 1) * 255).astype(int) - want.astype(int))
    interior = np.ones(diff.shape[2], bool)
    for k in range(1, n):
        interior[k * own - 4 : k * own + 4] = False
    assert diff[:, :, interior].max() == 0 == jdiff[:, :, interior].max()
    assert 0 < diff.max() <= 3 and np.abs(diff - jdiff).max() <= 1


def test_volume_matches_one_device_and_jax(tmp_path, tiny_pair):
    """A (16,140,40) volume through Zarr: equal to the one-device run at
    the slab's tile (the same convs on the same windows), to the one at the
    whole tile further than 4 rows from a slab seam, and to the JAX
    package's spatially sharded run within +-1 on under 1e-3 of voxels."""
    nc, params = tiny_pair
    shape = (16, 140, 40)
    raw = A.prepare_ds(str(tmp_path / "v.zarr" / "raw"), shape, (0, 0, 0), VS, np.uint8)
    raw[raw.roi] = np.random.default_rng(0).integers(0, 255, shape, dtype=np.uint8)

    def run(name, predictor, model):
        outs = prepare_prediction_outputs(str(tmp_path / f"{name}.zarr"), model, raw.roi, VS, predictor)
        return predictor.predict(raw, outs), outs["3d_affs"].to_ndarray()

    m = _model(nc, params)
    sp = S.SpatialShardedPredictor(m, VS, devices="cpu,cpu,cpu,cpu", shape_increase=[0, 104, 0],
                                   compute_dtype=torch.float32)
    stats, got = run("spatial", sp, m)
    assert (stats["devices"], stats["shard_axis"], stats["tiles"]) == (4, 1, 4 * 2 * 5)
    m1 = _model(nc, params)
    _, want = run("slab", Predictor(m1, VS, shape_increase=[0, 20, 0], device="cpu", compute_dtype=torch.float32), m1)
    np.testing.assert_array_equal(got, want)
    m1 = _model(nc, params)
    _, want = run("whole", Predictor(m1, VS, shape_increase=[0, 104, 0], device="cpu", compute_dtype=torch.float32), m1)
    interior = np.ones(shape[1], bool)
    for seam in (28, 56, 84, 112):  # the second tile's slabs start at y 28
        interior[seam - 4 : seam + 4] = False
    assert np.array_equal(got[:, :, interior], want[:, :, interior])

    jm = JModel(nc)
    jsp = JS.SpatialShardedPredictor(jm, params, VS, devices=jax.devices()[:4], shape_increase=[0, 104, 0],
                                     compute_dtype=jnp.float32)
    jraw = jax_open_ds(raw.path)
    jouts = jax_outputs(str(tmp_path / "jax.zarr"), jm, jraw.roi, VS, predictor=jsp)
    assert jsp.predict(jraw, jouts)["tiles"] == stats["tiles"]
    diff = np.abs(got.astype(int) - jouts["3d_affs"].to_ndarray().astype(int))
    assert diff.max() <= 1 and (diff != 0).mean() < 1e-3


def test_refusals_match_jax(tiny_pair):
    nc, params = tiny_pair
    with pytest.raises(ValueError, match="valid net input"):
        S.SpatialShardedPredictor(_model(nc, params), VS, devices=["cpu"] * 8, shape_increase=[0, 104, 0],
                                  shard_axis=1)
    with pytest.raises(ValueError, match="divisible"):
        S.SpatialShardedPredictor(_model(nc, params), VS, devices=["cpu"] * 3, shape_increase=[0, 104, 0],
                                  shard_axis=1)
    nc2 = get_net_config("2d_mtlsd")
    nc2.update(num_fmaps=2, fmap_inc_factor=2)
    with pytest.raises(ValueError, match="2D setups"):
        S.SpatialShardedPredictor(Model(nc2), VS, devices=["cpu"] * 2)
