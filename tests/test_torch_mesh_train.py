"""The port's mesh training (``train/loop.py``: ``make_mesh``, the space
ranks' windows, the sharded step over ``torch.distributed``) against the JAX package's
``make_mesh`` and ``shard_train_step`` on the virtual devices that
``tests/conftest.py`` forces, and against the one-device step, on the CPU
in fp32.

Tolerances: the slabs' gradients summed equal the one-device gradient
within atol 1e-5 (the same products in another order); a step over two
spawned gloo ranks equals the one-device step and the JAX mesh step with
the loss within 1e-5, the gradient that the step took (summed over the
ranks) and Adam's first moment within atol GRAD_ATOL, and the parameters
within atol 5e-4, the bound of ``tests/test_mesh_train.py``.  The
parameters' bound alone would not see a wrong gradient: Adam's first
update moves each parameter by at most the learning rate, whatever the
gradient, so the gradient and the moment are what hold the all_reduce,
and the parameters what hold the update.  A 2D net's windows (its y
pooled x8) hold their own rows to the whole tile's forward within 1e-6 in
fp32, and its spawned steps at (1,2), (2,2) and (1,4) hold the loss,
gradient and first moment as above.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_mesh_rank import one_sharded_step
from bootstrapper_torch.models import Model, init_params_numpy, load_params
from bootstrapper_torch.models import weights as W
from bootstrapper_torch.models.model import unet_config
from bootstrapper_torch.models.zoo import get_net_config
from bootstrapper_torch.train import loop as L
from bootstrapper_tpu.models import Model as JModel
from bootstrapper_tpu.train import loop as JL

LR = 1e-4
GRAD_ATOL = 1e-6


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
    """``tests/test_mesh_train.py``'s tiny net: (32,100,100) -> (4,8,8)."""
    nc = get_net_config("3d_affs")
    nc.update(num_fmaps=2, fmap_inc_factor=2, input_shape=[32, 100, 100], output_shape=[4, 8, 8],
              shape_increase=[0, 0, 0])
    return nc


def _small_net():
    """A two-level net for the spawned runs, whose JAX step compiles in a
    fraction of ``_net``'s time: (12,48,48) -> (4,8,8)."""
    nc = _net()
    nc.update(input_shape=[12, 48, 48], downsample_factors=[[1, 2, 2]] * 2,
              kernel_size_down=[[[1, 3, 3], [1, 3, 3]], [[3, 3, 3], [3, 3, 3]], [[3, 3, 3], [3, 3, 3]]],
              kernel_size_up=[[[1, 3, 3], [1, 3, 3]], [[1, 3, 3], [1, 3, 3]]])
    return nc


def _batch(n, seed, in_shape=(32, 100, 100)):
    rng = np.random.default_rng(seed)
    w = (rng.random((n, 4, 8, 8, 9)) > 0.3).astype(np.float32)  # some weights 0: the count matters
    return {
        "input": rng.standard_normal((n, *in_shape, 1)).astype(np.float32),
        "targets": {"3d_affs": rng.random((n, 4, 8, 8, 9)).astype(np.float32)},
        "weights": {"3d_affs": w},
    }


def _torch(batch):
    t = torch.from_numpy
    return {"input": t(batch["input"]), "targets": {k: t(v) for k, v in batch["targets"].items()},
            "weights": {k: t(v) for k, v in batch["weights"].items()}}


HINTS = [{}, {"data": 1}, {"data": 2}, {"batch_size": 1, "spatial": 4}, {"batch_size": 8, "spatial": 4},
         {"batch_size": 4, "spatial": 4}, {"spatial": 32}, {"batch_size": 10, "spatial": 4}, {"batch_size": 3}]


@pytest.mark.parametrize("hint", HINTS, ids=[",".join(f"{k}={v}" for k, v in h.items()) or "none" for h in HINTS])
def test_make_mesh_matches_jax(hint):
    for n in range(1, 9):
        if "data" in hint and n % hint["data"]:
            continue
        grid = L.make_mesh(n, devices=["cpu"] * 8, **hint)
        assert (len(grid), len(grid[0])) == JL.make_mesh(n, **hint).devices.shape, n
        assert all(len(row) == len(grid[0]) for row in grid)


def test_backend_choice():
    assert L.mesh_backend(["cuda:0", "cuda:1"]) == "nccl"
    assert L.mesh_backend(["cuda:0", "cuda:0"]) == "gloo"
    assert L.mesh_backend(["cpu", "cpu"]) == "gloo"


@pytest.mark.parametrize("grid", [(2, 2), (1, 4), (4, 1)])
def test_slab_gradients_sum_to_one_device(grid):
    """In one process: each rank's slab loss over the whole batch's count,
    summed over the ranks, is the one-device loss, and so are the
    gradients."""
    data, space = grid
    nc = _net()
    batch = _torch(_batch(4, 7))
    model = load_params(Model(nc, compute_dtype=torch.float32), init_params_numpy(nc, 0))
    want = L.loss_fn(model, batch)
    want.backward()
    want_grads = [p.grad.clone() for p in model.parameters()]
    model.zero_grad()
    rows = 4 // data
    slabs = []
    for d in range(data):
        group = {part: ({k: v[d * rows : (d + 1) * rows] for k, v in batch[part].items()} if part != "input"
                        else batch[part][d * rows : (d + 1) * rows]) for part in batch}
        slabs += [L.rank_slab(group, model.unet_config, 3, space, s) for s in range(space)]
    counts = sum(L.slab_counts(sl) for sl in slabs)
    assert float(counts[0]) == float((batch["weights"]["3d_affs"] > 0).sum())
    total = 0.0
    for sl in slabs:
        assert sl["input"].shape[1] == 4 // space + 28
        loss = L.loss_fn(model, sl, {"3d_affs": counts[0]})
        loss.backward()  # accumulates: the sum over the ranks
        total += float(loss.detach())
    assert total == pytest.approx(float(want.detach()), rel=1e-5)
    for p, g in zip(model.parameters(), want_grads):
        np.testing.assert_allclose(p.grad.numpy(), g.numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("grid", [(1, 2), (2, 1)], ids=["space2", "data2"])
def test_spawned_step_matches_one_device_and_jax(grid, monkeypatch):
    """Two gloo ranks, each a spawned process on the CPU (one torch thread
    each): one step from rank 0's parameters (broadcast) on the same batch
    as the one-device step and as the JAX package's mesh step."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    data, space = grid
    nc = _small_net()
    params = init_params_numpy(nc, 0)
    batch = _batch(2, 3, tuple(nc["input_shape"]))
    mesh_grid = L.make_mesh(2, data=data, devices=["cpu", "cpu"])
    got = L.spawn_mesh(one_sharded_step, mesh_grid, args=(nc, params, batch, LR))
    assert L.mesh_backend(["cpu", "cpu"]) == "gloo" and got["step"] == 1

    model = load_params(Model(nc, compute_dtype=torch.float32), params)
    state = L.TrainState(0, model, L.make_optimizer(model, LR))
    state, metrics = L.make_train_step()(state, _torch(batch))
    assert got["loss"] == pytest.approx(float(metrics["loss"]), abs=1e-5)
    want = W.params_to_jax(model)
    want_grads = {k: W.to_jax_layout(model, k, p.grad.numpy()) for k, p in W.params_in_leaf_order(model)}
    assert sorted(got["params"]) == sorted(want) == sorted(got["grads"]) == sorted(want_grads)
    assert max(float(np.abs(g).max()) for g in want_grads.values()) > 100 * GRAD_ATOL  # a gradient to hold
    for k in want:
        np.testing.assert_allclose(got["grads"][k], want_grads[k], rtol=0, atol=GRAD_ATOL, err_msg=k)
        np.testing.assert_allclose(got["exp_avg"][k], 0.1 * want_grads[k], rtol=0, atol=0.1 * GRAD_ATOL, err_msg=k)
        np.testing.assert_allclose(got["params"][k], want[k], rtol=0, atol=5e-4)

    jm = JModel(nc, compute_dtype=jnp.float32)
    tx = optax.adam(LR)
    jstate = JL.TrainState(jnp.zeros((), jnp.int32), params, tx.init(params))
    mesh = JL.make_mesh(2, data=data)
    jitted, place = JL.shard_train_step(JL.make_train_step(jm, tx), mesh)
    with mesh:
        jstate, jmetrics = jitted(*place(jstate, batch))
    assert got["loss"] == pytest.approx(float(jmetrics["loss"]), abs=1e-5)
    jflat = W._flatten(jax.tree_util.tree_map(np.asarray, jstate.params))
    # optax's first moment after one step is 0.1 of the JAX mesh step's gradient
    jmu = W._flatten(jax.tree_util.tree_map(np.asarray, jstate.opt_state[0].mu))
    for k in want:
        np.testing.assert_allclose(got["exp_avg"][k], jmu[k], rtol=0, atol=0.1 * GRAD_ATOL, err_msg=k)
        np.testing.assert_allclose(got["grads"][k], jmu[k] / 0.1, rtol=0, atol=GRAD_ATOL, err_msg=k)
        np.testing.assert_allclose(got["params"][k], jflat[k], rtol=0, atol=5e-4)


def _net_2d(**kw):
    """A narrow 2d_mtlsd (both heads, the x8 pooling of y and x)."""
    nc = get_net_config("2d_mtlsd")
    nc.update(num_fmaps=2, fmap_inc_factor=2, **kw)
    return nc


def _whole_and_windows(nc, space, seed=0):
    """The whole tile's forward and each space rank's window forward (fp32),
    on one random input of the config's tile."""
    model = load_params(Model(nc, compute_dtype=torch.float32), init_params_numpy(nc, seed))
    cfg = model.unet_config
    x = torch.from_numpy(
        np.random.default_rng(seed).standard_normal((1, *nc["input_shape"], cfg.in_channels)).astype(np.float32))
    ctx = nc["input_shape"][0] - nc["output_shape"][0]
    with torch.no_grad():
        whole = model(x)
        windows = L.mesh_windows(cfg, nc["input_shape"], nc["output_shape"], space)
        outs = [model(x.narrow(1, w.start, w.rows + ctx)) for w in windows]
    return model, x, whole, windows, outs


def _own_rows_diff(whole, windows, outs) -> float:
    return max(
        float((o[k].narrow(1, w.own, w.own_rows) - whole[k].narrow(1, w.start + w.own, w.own_rows)).abs().max())
        for w, o in zip(windows, outs) for k in o
    )


def test_2d_space_split_raises_naming_a3():
    """A 2D net's first axis is pooled x8, and the (1, 4) factorisation that
    ``make_mesh`` gives its published tile leaves the pooling lattice at
    every seam: the space ranks train windows on the lattice instead (no
    refusal), each reaching the seam margin of 5 output rows past its own 26
    rows, and their own rows are the whole tile's forward (fp32, 1e-6)."""
    nc = _net_2d()
    grid = L.make_mesh(4, batch_size=1, spatial=4, devices=["cpu"] * 4)
    assert (len(grid), len(grid[0])) == (1, 4)
    assert L.seam_margin(unet_config(nc), 196) == 5
    _, _, whole, windows, outs = _whole_and_windows(nc, 4)
    assert [(w.start, w.rows, w.own, w.own_rows) for w in windows] == [
        (0, 32, 0, 26), (16, 48, 10, 26), (40, 48, 12, 26), (72, 32, 6, 26)]
    assert [w.start + w.own for w in windows] == [0, 26, 52, 78]
    assert _own_rows_diff(whole, windows, outs) <= 1e-6


WINDOW_CASES = [("resize", 2), ("transposed", 2), ("transposed", 4), ("3d", 2)]


@pytest.mark.parametrize("up,space", WINDOW_CASES, ids=[f"{u}_space{s}" for u, s in WINDOW_CASES])
def test_windows_own_rows_equal_the_whole_tile(up, space):
    """Each window starts on the pooling lattice, has a valid input length,
    and its own rows equal the whole tile's forward (fp32, 1e-6); a
    transposed upsample has no reach (margin 0), and a 3D net that never
    pools z keeps the plain slabs (its own rows and the context)."""
    if up == "3d":
        nc = _net()
    else:
        nc = _net_2d(input_shape=[148, 100], output_shape=[56, 8], constant_upsample=up == "resize")
    cfg = unet_config(nc)
    _, _, whole, windows, outs = _whole_and_windows(nc, space)
    lattice = int(np.prod([f[0] for f in cfg.downsample_factors]))
    n_out = nc["output_shape"][0]
    assert [w.start + w.own for w in windows] == list(range(0, n_out, n_out // space))
    assert all(w.start % lattice == 0 and w.start + w.rows <= n_out for w in windows)
    margin = L.seam_margin(cfg, nc["input_shape"][0])
    assert margin == {"resize": 5, "transposed": 0, "3d": 0}[up]
    if up != "resize":
        assert all(w.rows == w.own_rows == n_out // space for w in windows) or lattice > 1
    if up == "3d":
        assert [(w.start, w.rows) for w in windows] == [(s * n_out // space, n_out // space) for s in range(space)]
    assert _own_rows_diff(whole, windows, outs) <= 1e-6


def test_window_without_seam_margin_differs():
    """The margin is needed: rank 1 of 2 owns the output rows [28, 56), and
    a window on the x8 lattice from row 24 (4 rows short of the margin of
    5) differs from the whole tile in its first own row; only the 5 rows
    next to its inner edge differ (fp32: the others are 0 apart)."""
    nc = _net_2d(input_shape=[148, 100], output_shape=[56, 8])
    model, x, whole, _, _ = _whole_and_windows(nc, 2)
    with torch.no_grad():
        out = model(x.narrow(1, 24, 32 + 92))
    diff = torch.stack([(out[k] - whole[k].narrow(1, 24, 32)).abs().amax(dim=(0, 2, 3)) for k in out]).amax(0)
    assert float(diff[4]) > 1e-6  # the first own row
    assert float(diff[5:].max()) == 0.0


def _small_net_2d():
    """A two-level 2d_mtlsd for the spawned steps, whose JAX step compiles
    in a fraction of the three-level net's time: y pooled x4, (72, 44) ->
    (32, 4), a seam margin of 3."""
    return _net_2d(input_shape=[72, 44], output_shape=[32, 4], downsample_factors=[[2, 2], [2, 2]],
                   kernel_size_down=[[[3, 3], [3, 3]]] * 3, kernel_size_up=[[[3, 3], [3, 3]]] * 2)


def _batch_2d(nc, n, seed):
    rng = np.random.default_rng(seed)
    out = nc["output_shape"]
    heads = {k: v["dims"] for k, v in nc["outputs"].items()}
    return {
        "input": rng.standard_normal((n, *nc["input_shape"], 3)).astype(np.float32),
        "targets": {k: rng.random((n, *out, c)).astype(np.float32) for k, c in heads.items()},
        "weights": {k: (rng.random((n, *out, c)) > 0.3).astype(np.float32) for k, c in heads.items()},
    }


MESH_2D = [(1, 2), (2, 2), (1, 4)]


@pytest.mark.parametrize("grid", MESH_2D, ids=[f"{d}data_{s}space" for d, s in MESH_2D])
def test_2d_mesh_step_matches_one_device_and_jax(grid, monkeypatch):
    """A 2D net whose space axis splits its pooled y: one spawned step
    over ``data * space`` gloo ranks (windows) against the one-device step
    and the JAX package's ``shard_train_step`` at the same factorisation
    (GSPMD), the loss within 1e-5, the gradient that the step took and
    Adam's first moment within GRAD_ATOL."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    data, space = grid
    nc = _small_net_2d()
    assert L.seam_margin(unet_config(nc), 72) == 3
    assert all(w.rows < 32 for w in L.mesh_windows(unet_config(nc), (72, 44), (32, 4), space))
    params = init_params_numpy(nc, 0)
    batch = _batch_2d(nc, data, 5)
    mesh_grid = L.make_mesh(data * space, data=data, devices=["cpu"] * (data * space))
    assert (len(mesh_grid), len(mesh_grid[0])) == grid
    got = L.spawn_mesh(one_sharded_step, mesh_grid, args=(nc, params, batch, LR))

    model = load_params(Model(nc, compute_dtype=torch.float32), params)
    state = L.TrainState(0, model, L.make_optimizer(model, LR))
    state, metrics = L.make_train_step()(state, _torch(batch))
    assert got["loss"] == pytest.approx(float(metrics["loss"]), abs=1e-5)
    want_grads = {k: W.to_jax_layout(model, k, p.grad.numpy()) for k, p in W.params_in_leaf_order(model)}
    assert max(float(np.abs(g).max()) for g in want_grads.values()) > 100 * GRAD_ATOL  # a gradient to hold
    for k in want_grads:
        np.testing.assert_allclose(got["grads"][k], want_grads[k], rtol=0, atol=GRAD_ATOL, err_msg=k)
        np.testing.assert_allclose(got["exp_avg"][k], 0.1 * want_grads[k], rtol=0, atol=0.1 * GRAD_ATOL, err_msg=k)

    jm = JModel(nc, compute_dtype=jnp.float32)
    tx = optax.adam(LR)
    jstate = JL.TrainState(jnp.zeros((), jnp.int32), params, tx.init(params))
    mesh = JL.make_mesh(data * space, data=data)
    assert mesh.devices.shape == grid
    jitted, place = JL.shard_train_step(JL.make_train_step(jm, tx), mesh)
    with mesh:
        jstate, jmetrics = jitted(*place(jstate, batch))
    assert got["loss"] == pytest.approx(float(jmetrics["loss"]), abs=1e-5)
    jmu = W._flatten(jax.tree_util.tree_map(np.asarray, jstate.opt_state[0].mu))
    for k in want_grads:
        np.testing.assert_allclose(got["exp_avg"][k], jmu[k], rtol=0, atol=0.1 * GRAD_ATOL, err_msg=k)
        np.testing.assert_allclose(got["grads"][k], jmu[k] / 0.1, rtol=0, atol=GRAD_ATOL, err_msg=k)
