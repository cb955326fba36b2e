"""The port's 2D setups against the JAX package's, on the CPU in fp32, at
narrow widths (``num_fmaps`` 2, ``fmap_inc_factor`` 2) and the smallest
valid tiles:

- the 2D ``Model`` forward (the port runs its plain lifted unit-z graph,
  the JAX package its lifted and folded one): within 1e-4, at a width
  whose 144- and 864-channel levels take the kernel route too, and with
  one ``adj_slices`` section non-zero at a time, which pins the order in
  which sections become channels;
- 2D checkpoints written by either package and read by the other: equal;
- ``apply_shift`` against ``shift_augment`` on the same shifts: exact;
- the 2D device transform given the JAX transform's draws: affinities and
  weights exact (unless a deform sample lies on a half voxel), LSDs
  within 1e-5, the input within 2e-5;
- two train steps from the same parameters and batch: each loss within
  rtol 1e-4 (the second after one Adam update on each side).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bootstrapper_torch.models import Model, init_params_numpy, load_checkpoint, load_params, save_checkpoint
from bootstrapper_torch.models.weights import params_in_leaf_order, params_to_jax
from bootstrapper_torch.models.zoo import get_net_config
from bootstrapper_torch.ops import conv3d as C
from bootstrapper_torch.pipeline import augment as AUG
from bootstrapper_torch.pipeline import training as T
from bootstrapper_torch.train import loop as L
from bootstrapper_torch.train import sampler as S
from bootstrapper_tpu.models.model import Model as JModel
from bootstrapper_tpu.pipeline import augment as JAUG
from bootstrapper_tpu.pipeline import training as JT
from bootstrapper_tpu.train import loop as JL
from test_torch_training_pipeline import _deform_ties, _voronoi, jax_transform_draws

VOXEL = (40, 4, 4)
# the smallest valid 2d_mtlsd tile: (100, 100) -> (8, 8)
TILE, OUT = (100, 100), (8, 8)


def net_config_2d(num_fmaps=2, inc=2, tile=TILE, out=OUT, **kw):
    nc = get_net_config("2d_mtlsd")
    nc.update(num_fmaps=num_fmaps, fmap_inc_factor=inc, input_shape=list(tile), output_shape=list(out), **kw)
    return nc


@pytest.fixture(scope="module")
def narrow():
    """The narrow 2D net, seeded params and the JAX ``Model.apply`` of it,
    compiled once for the module (a batch of 3 sections' stacks)."""
    nc = net_config_2d()
    return nc, init_params_numpy(nc, 1), jax.jit(JModel(nc, compute_dtype=jnp.float32).apply)


def _forward_matches(nc, params, japply, x):
    ref = japply(params, jnp.asarray(x))
    model = load_params(Model(nc, compute_dtype=torch.float32), params).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    for name in ("2d_lsds", "2d_affs"):
        assert got[name].shape == ref[name].shape == (x.shape[0], *OUT, 6)
        np.testing.assert_allclose(got[name].numpy(), np.asarray(ref[name]), rtol=1e-4, atol=1e-6)
    return {k: v.numpy() for k, v in got.items()}


@pytest.mark.parametrize("width", ["narrow", "kernel_route"])
def test_2d_forward_matches_jax_fp32(narrow, width):
    """``narrow``: 2 -> 4 -> 8 -> 16 channels, the library route only;
    ``kernel_route``: 4 -> 24 -> 144 -> 864, whose two widest levels take
    the kernel route (its plain version here) at ``kd = 1``."""
    x = np.random.default_rng(0).uniform(-1, 1, (3, 3, *TILE, 1)).astype(np.float32)
    if width == "narrow":
        nc, params, japply = narrow
    else:
        nc = net_config_2d(4, 6)
        params = init_params_numpy(nc, 1)
        japply = jax.jit(JModel(nc, compute_dtype=jnp.float32).apply)
    before = C.COUNTS["plain"]
    _forward_matches(nc, params, japply, x)
    assert (C.COUNTS["plain"] > before) == (width == "kernel_route")


def test_2d_adj_slices_channel_order(narrow):
    """Sample ``d`` of the batch has only section ``d`` non-zero: each
    section reaches the first conv's weights of channel ``d * C + c`` in
    both packages (a swapped order gives another output for every section
    but the centre), and each moves the output its own way."""
    x = np.zeros((3, 3, *TILE, 1), np.float32)
    rng = np.random.default_rng(1)
    for d in range(3):
        x[d, d] = rng.uniform(-1, 1, (*TILE, 1))
    got = _forward_matches(*narrow, x)["2d_affs"]
    assert min(np.abs(got[a] - got[b]).max() for a, b in ((0, 1), (1, 2), (0, 2))) > 1e-4


def test_2d_stack_infer_keeps_a_unit_z():
    nc = net_config_2d()
    model = load_params(Model(nc, compute_dtype=torch.float32, stack_infer=True), init_params_numpy(nc, 0))
    with torch.no_grad():
        out = model(torch.zeros((3, 3, *TILE, 1)))
    assert {k: tuple(v.shape) for k, v in out.items()} == {k: (3, 1, *OUT, 6) for k in ("2d_lsds", "2d_affs")}


def test_2d_checkpoints_read_by_either_package(tmp_path):
    """A 2D checkpoint of the port's trainer (params and Adam's state) in
    the JAX loader, and the JAX trainer's in the port: HWIO weights, the
    port's lifted ones squeezed and re-lifted, the moments too."""
    nc = net_config_2d()
    params = init_params_numpy(nc, 3)
    # the port's: one Adam step so the moments are not zero
    state = L.create_train_state(Model(nc, compute_dtype=torch.float32), 3)
    batch = _batch(nc, 0)
    L.make_train_step()(state, _to_torch(batch))
    path = L.save_checkpoint(str(tmp_path / "port"), state, 1)
    tx = optax.adam(1e-4)
    js = JL.load_checkpoint(path, tx)
    want = params_to_jax(state.model)
    got = {k: np.asarray(v) for k, v in _flat(js.params).items()}
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].shape == v.shape and np.array_equal(got[k], v), k
    assert all(np.asarray(got[k]).ndim == 4 for k in got if k.endswith("/w"))
    mu = _flat(js.opt_state[0].mu)
    for p_path, p in params_in_leaf_order(state.model):
        want_mu = state.optimizer.state[p]["exp_avg"].numpy()
        np.testing.assert_array_equal(np.asarray(mu[p_path]), want_mu[0] if p_path.endswith("/w") else want_mu)
    # the JAX package's: written from the same params, read by the port
    jstate = JL.TrainState(jnp.asarray(7, jnp.int32), jax.tree_util.tree_map(jnp.asarray, params), tx.init(params))
    jpath = JL.save_checkpoint(str(tmp_path / "jax"), jstate, 7)
    loaded = load_params(Model(nc, compute_dtype=torch.float32), load_checkpoint(jpath))
    resumed = L.load_checkpoint(jpath, L.create_train_state(Model(nc, compute_dtype=torch.float32), 0))
    assert resumed.step == 7
    for p_path, p in params_in_leaf_order(loaded):
        arr = _flat(params)[p_path]
        assert np.array_equal(p.detach().numpy(), arr[None] if p_path.endswith("/w") else arr), p_path
    # and the port's own npz writer, read back by the JAX params loader
    save_checkpoint(str(tmp_path / "params"), params, 2)
    back = _flat(JL.load_params(str(tmp_path / "params" / "model_checkpoint_2")))
    assert all(np.array_equal(np.asarray(back[k]), v) for k, v in _flat(params).items())


def _flat(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            if not str(k).startswith("_pf"):
                out.update(_flat(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


# -- the shift augment and the 2D transform ------------------------------------


@pytest.mark.parametrize("seed", range(3))
def test_shift_apply_matches_jax_exactly(seed):
    """The JAX draw (a coin per section, shifts of mixed signs) applied by
    both packages: ``torch.roll`` wraps around as ``jnp.roll`` does."""
    rng = np.random.default_rng(seed)
    arrays = {
        "raw": rng.random((5, 17, 13), dtype=np.float32),
        "labels": rng.integers(0, 9, (5, 17, 13)).astype(np.int32),
    }
    key = jax.random.PRNGKey(seed)
    want = JAUG.shift_augment(key, {k: jnp.asarray(v) for k, v in arrays.items()}, {"labels": 0}, 3, 0.6)
    kp, ks = jax.random.split(key)
    hit = np.asarray(jax.random.bernoulli(kp, 0.6, (5,)))
    shifts = np.asarray(jax.random.randint(ks, (5, 2), -3, 4))
    shifts = [tuple(int(v) for v in s) if h else (0, 0) for h, s in zip(hit, shifts)]
    assert any(s[0] * s[1] < 0 for s in shifts) or seed != 0  # mixed signs are drawn
    got = AUG.apply_shift({k: torch.from_numpy(v) for k, v in arrays.items()}, shifts)
    for k in arrays:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    fresh = AUG.shift_augment(AUG.Generators(seed), {k: torch.from_numpy(v) for k, v in arrays.items()}, {}, 3, 0.6)
    assert all(fresh[k].shape == arrays[k].shape and fresh[k].dtype == got[k].dtype for k in arrays)
    drawn = AUG.draw_shift(AUG.Generators(seed), 200, max_shift=3, prob=0.2)["shifts"]
    moved = [s for s in drawn if s != (0, 0)]
    assert 0 < len(moved) < 100 and max(max(abs(v) for v in s) for s in moved) <= 3


def _jax_2d_draws(key, spec):
    """``jax_transform_draws`` plus the 2D transform's shift: its gate on
    key 4, its draws on key 3."""
    draws = jax_transform_draws(key, spec)
    keys = jax.random.split(key, 12)
    if bool(jax.random.bernoulli(keys[4], 0.5)):
        kp, ks = jax.random.split(keys[3])
        z = spec.input_tile[0]
        hit = np.asarray(jax.random.bernoulli(kp, T.SHIFT_PROB, (z,)))
        sh = np.asarray(jax.random.randint(ks, (z, 2), -T.MAX_SHIFT, T.MAX_SHIFT + 1))
        draws["shift"] = {"shifts": [tuple(int(v) for v in s) if h else (0, 0) for h, s in zip(hit, sh)]}
    return draws


@pytest.fixture(scope="module")
def transform_2d():
    """The 2D spec at a (60, 60) tile and the JAX transform of it, compiled
    once for the module."""
    nc = net_config_2d(tile=(60, 60), out=(24, 24))
    return T.SetupSpec(nc, VOXEL), jax.jit(JT.make_device_transform(JT.SetupSpec(nc, VOXEL)))


@pytest.mark.parametrize("seed", [1, 2, 6, 10])  # 2, 6 and 10 shift a section; 6 and 10 deform
def test_2d_transform_matches_jax_given_its_draws(transform_2d, seed):
    spec_p, jax_transform = transform_2d
    assert spec_p.input_tile == (3, 60, 60) and spec_p.output_tile == (1, 24, 24)
    assert (spec_p.batch_size, spec_p.learning_rate) == (10, 1e-4)
    shape = spec_p.input_tile
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 256, shape, dtype=np.uint8)
    labels = S.fold_ids_u32(_voronoi(shape, 20, seed))
    mask = (rng.random(shape) > 0.05).astype(np.uint8)
    mask[:, :3] = 0
    key = jax.random.PRNGKey(seed)
    want_in, want_t, want_w = jax_transform(key, jnp.asarray(raw), jnp.asarray(labels), jnp.asarray(mask))
    draws = _jax_2d_draws(key, spec_p)
    b = T.upload({"raw": raw[None], "labels": labels[None], "mask": mask[None]}, "cpu")
    got_in, got_t, got_w = T.apply_transform(spec_p, draws, b["raw"][0], b["labels"][0], b["mask"][0])
    assert got_in.shape == (*shape, 1)
    assert {k: tuple(v.shape) for k, v in got_t.items()} == {"2d_lsds": (24, 24, 6), "2d_affs": (24, 24, 6)}
    np.testing.assert_allclose(got_in.numpy(), np.asarray(want_in), rtol=0, atol=2e-5)
    lsd_close = np.abs(got_t["2d_lsds"].numpy() - np.asarray(want_t["2d_lsds"])).max() <= 1e-5
    exact = all(np.array_equal(got[k].numpy(), np.asarray(want[k]))
                for got, want in ((got_t, want_t), (got_w, want_w)) for k in ("2d_affs",))
    exact &= np.array_equal(got_w["2d_lsds"].numpy(), np.asarray(want_w["2d_lsds"]))
    assert (exact and lsd_close) or ("deform" in draws and _deform_ties(key, spec_p))
    assert float(got_t["2d_lsds"].max()) > 0 and float(got_t["2d_affs"].sum()) > 0


def test_2d_pipeline_batches_of_ten(tmp_path):
    """The 2D pipeline end to end on the CPU: a batch of ten sections'
    worth of crops, 2D targets, and every gate (the shift too) both ways."""
    from bootstrapper_torch.core import arrays as A

    shape = (8, 80, 80)
    rng = np.random.default_rng(5)
    data = {
        "raw": rng.integers(0, 256, shape, dtype=np.uint8),
        "labels": _voronoi(shape, 20, 5),
        "mask": np.ones(shape, np.uint8),
    }
    paths = {}
    for k, a in data.items():
        paths[k] = str(tmp_path / "s.zarr" / k)
        ds = A.prepare_ds(paths[k], a.shape, (0, 0, 0), VOXEL, a.dtype)
        ds[ds.roi] = a
    nc = net_config_2d(tile=(60, 60), out=(24, 24))
    pipe = T.TrainingPipeline(nc, VOXEL, [S.Sample.open(paths["raw"], paths["labels"], paths["mask"])],
                              device="cpu", num_threads=1, prefetch=1)
    try:
        b = pipe.next_batch()
    finally:
        pipe.stop()
    assert pipe.batch_size == 10 and b["input"].shape == (10, 3, 60, 60, 1)
    assert all(b["targets"][k].shape == b["weights"][k].shape == (10, 24, 24, 6) for k in ("2d_lsds", "2d_affs"))
    gen = AUG.Generators(0)
    seen = set()
    for _ in range(8):
        seen.add("shift" in T.draw_transform(gen, T.SetupSpec(nc, VOXEL)))
    assert seen == {True, False}


# -- one train step --------------------------------------------------------------


def _batch(nc, seed, n=2):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, 3, *nc["input_shape"], 1)).astype(np.float32)
    out = (n, nc["output_shape"][0] + 2, nc["output_shape"][1] + 2, 6)  # cropped to the output
    batch = {"input": x, "targets": {}, "weights": {}}
    for k in ("2d_lsds", "2d_affs"):
        batch["targets"][k] = rng.random(out).astype(np.float32)
        w = (rng.random(out) * 2).astype(np.float32)
        w[w < 0.5] = 0
        batch["weights"][k] = w
    return batch


def _to_torch(batch):
    return jax.tree_util.tree_map(torch.from_numpy, batch)


def test_2d_train_steps_match_jax():
    """Two steps of each package's train step (Adam at the 2D rate, 1e-4)
    from the same numpy parameters on the same batch: each step's loss
    within rtol 1e-4."""
    nc = net_config_2d(fold_xy=False)  # as the JAX trainer runs a batch it does not fold
    params = init_params_numpy(nc, 4)
    batch = _batch(nc, 1)
    tx = optax.adam(1e-4)
    jstep = jax.jit(JL.make_train_step(JModel(nc, compute_dtype=jnp.float32), tx))
    jstate = JL.TrainState(jnp.zeros((), jnp.int32), jax.tree_util.tree_map(jnp.asarray, params), tx.init(params))
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    model = load_params(Model(nc, compute_dtype=torch.float32), params)
    state = L.TrainState(0, model, L.make_optimizer(model, T.SetupSpec(nc, VOXEL).learning_rate))
    step = L.make_train_step()
    tbatch = _to_torch(batch)
    for _ in range(2):
        jstate, jm = jstep(jstate, jbatch)
        state, m = step(state, tbatch)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-4)
    assert state.step == int(jstate.step) == 2
