"""The port's mesh training (``train/loop.py``: ``make_mesh``, the slabs,
the sharded step over ``torch.distributed``) against the JAX package's
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
and the parameters what hold the update.
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
from bootstrapper_torch.workflows import run_training
from bootstrapper_torch.utils import tomlio
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


def test_2d_space_split_raises_naming_a3(tmp_path):
    """A 2D net's first axis is pooled x8: four space ranks would leave the
    lattice, which the port refuses before its first step (the JAX package
    shards it through GSPMD)."""
    nc = get_net_config("2d_mtlsd")
    grid = L.make_mesh(4, batch_size=1, spatial=4, devices=["cpu"] * 4)
    assert (len(grid), len(grid[0])) == (1, 4)
    with pytest.raises(ValueError, match="A3"):
        L.check_mesh_slabs(unet_config(nc), nc["input_shape"], nc["output_shape"], grid)
    setup = tmp_path / "2d_mtlsd"
    setup.mkdir()
    (setup / "net_config.json").write_text(__import__("json").dumps(nc))
    samples = [{"raw": str(tmp_path / "none.zarr/raw"), "labels": str(tmp_path / "none.zarr/labels")}]
    tomlio.dump({"train": {"setup_dir": str(setup), "samples": samples, "batch_size": 1, "mesh": True}},
                str(tmp_path / "t.toml"))
    with pytest.raises(ValueError, match=r"\(1 data, 4 space\).*A3"):
        run_training(str(tmp_path / "t.toml"), device="cpu,cpu,cpu,cpu")
