"""bootstrapper_torch's synthetic training (``train/synth.py``,
``pipeline/synthetic.py``) against the JAX package's, on the same numpy
inputs made from a seed:

- the label generator and the obfuscation: exact for the same numpy seed;
- the synthetic device transform, given the draws the JAX transform makes
  from its key, for each of the four input kinds the shipped refiners take
  (2D affinities, 2D LSDs, both, 3D LSDs): the net input within 2e-5,
  targets and weights exactly; one draw holds more than MAX_LABELS ids;
- the pipeline on the CPU: the JAX package's host draws, shapes, ranges;
- a narrow refiner trained through ``run_training`` with no samples: its
  checkpoint resumes in the JAX trainer.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bootstrapper_torch.models.model import unet_config
from bootstrapper_torch.models.unet import compute_output_shape
from bootstrapper_torch.models.zoo import get_net_config
from bootstrapper_torch.pipeline import synthetic as SY
from bootstrapper_torch.pipeline.augment import Generators
from bootstrapper_torch.pipeline.training import SetupSpec, upload
from bootstrapper_torch.train import synth as P
from bootstrapper_torch.train.sampler import fold_ids_u32
from bootstrapper_torch.utils import tomlio
from bootstrapper_torch.workflows import run_training
from bootstrapper_tpu.pipeline import synthetic as JSY
from bootstrapper_tpu.train import loop as JL
from bootstrapper_tpu.train import synth as J

SHAPE = (12, 48, 48)
OUT = (4, 8, 8)
VOXEL = (1, 1, 1)
KINDS = ["3d_affs_from_2d_affs", "3d_affs_from_2d_lsd", "3d_affs_from_2d_mtlsd", "3d_affs_from_3d_lsd"]


# -- train/synth.py ------------------------------------------------------------


@pytest.mark.parametrize("mode", ["random", "tubes"])
@pytest.mark.parametrize("seed", [0, 3, 5])
def test_create_labels_exact(seed, mode):
    got = P.create_labels(np.random.default_rng(seed), SHAPE, mode=mode)
    want = J.create_labels(np.random.default_rng(seed), SHAPE, mode=mode)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("p", [1.0, None])  # every error kind in every section; the defaults
def test_obfuscate_and_pair_exact(p):
    labels = J.create_labels(np.random.default_rng(2), SHAPE, mode="random")
    kw = {} if p is None else {"p_split": p, "p_merge": p, "p_artifact": p}
    got = P.obfuscate_labels(np.random.default_rng(7), labels, **kw)
    want = J.obfuscate_labels(np.random.default_rng(7), labels, **kw)
    np.testing.assert_array_equal(got, want)
    assert (got != labels).any()
    for g, w in zip(P.synthetic_pair(np.random.default_rng(4), SHAPE, **kw),
                    J.synthetic_pair(np.random.default_rng(4), SHAPE, **kw)):
        np.testing.assert_array_equal(g, w)


# -- the device transform, given JAX's draws -----------------------------------


def _net_config(kind):
    """The shipped refiner's inputs and outputs at a narrow tile."""
    nc = get_net_config(kind)
    nc.update(input_shape=list(SHAPE), output_shape=list(OUT))
    return nc


def jax_synth_draws(key, spec):
    """The draws the JAX ``make_synth_device_transform`` makes from ``key``,
    split as it splits them, in the port's form."""
    keys = jax.random.split(key, 10)
    c, z = SY.input_channels(spec.net_config), spec.input_tile[0]

    def coin(k):
        return bool(jax.random.bernoulli(k, 0.5))

    def uniforms(k, n, lo, hi):
        return torch.tensor([float(jax.random.uniform(kk, (), minval=lo, maxval=hi)) for kk in jax.random.split(k, n)])

    def intensity(k, n):
        scale, shift = [], []
        for kk in jax.random.split(k, n):
            k1, k2 = jax.random.split(kk)
            scale.append(float(jax.random.uniform(k1, (), minval=0.9, maxval=1.1)))
            shift.append(float(jax.random.uniform(k2, (), minval=-0.1, maxval=0.1)))
        return {"scale": torch.tensor(scale), "shift": torch.tensor(shift)}

    km, kt = jax.random.split(keys[0])
    draws = {
        "simple": {
            "flips": [bool(f) for f in np.asarray(jax.random.bernoulli(km, 0.5, (3,)))],
            "transpose": coin(kt),
        }
    }
    if coin(keys[1]):
        k1, k2 = jax.random.split(keys[1])
        draws["noise"] = {
            "sigma": float(jax.random.uniform(k1, (), maxval=0.05)),
            "noise": torch.from_numpy(np.array(jax.random.normal(k2, (c, *spec.input_tile)))),
        }
    if coin(keys[2]):
        draws["intensity_channel"] = intensity(keys[2], c)
    if coin(keys[6]):
        draws["intensity_section"] = intensity(keys[6], z)
    if coin(keys[3]):
        draws["gamma"] = {"log_gamma": uniforms(keys[3], z, np.log(0.8), np.log(1.25))}
    if coin(keys[4]):
        draws["smooth"] = {"sigma": uniforms(keys[4], z, 0.0, 1.5)}
    kd = jax.random.split(keys[5], 4)[0]
    draws["defect"] = {"u": np.asarray(jax.random.uniform(kd, (z,))).tolist(), "alpha": [0.5] * z}
    return draws


@functools.lru_cache(maxsize=None)
def _jax_transform(kind):
    return jax.jit(JSY.make_synth_device_transform(_net_config(kind), VOXEL))


def _pair(seed, many_ids=False):
    """A clean/obfuscated pair as the host ships it (uint32 ids); with
    ``many_ids`` small objects, more than MAX_LABELS of them."""
    rng = np.random.default_rng(seed)
    if many_ids:
        clean = P.create_labels(rng, SHAPE, mode="random", sigma=1.0)
        obf = P.obfuscate_labels(rng, clean)
    else:
        clean, obf = P.synthetic_pair(rng, SHAPE)
    return fold_ids_u32(clean), fold_ids_u32(obf)


# the seeds draw each gate both ways over each kind (test_gates_both_ways)
SEEDS = [2, 3, 10]
CASES = [(k, s, False) for k in KINDS for s in SEEDS] + [("3d_affs_from_2d_mtlsd", 3, True)]


@pytest.mark.parametrize("kind,seed,many_ids", CASES)
def test_synth_transform_matches_jax_given_its_draws(kind, seed, many_ids):
    nc = _net_config(kind)
    spec = SetupSpec(nc, VOXEL)
    clean, obf = _pair(seed, many_ids)
    if many_ids:
        assert len(np.unique(clean)) > SY.MAX_LABELS
    key = jax.random.PRNGKey(seed)
    want_in, want_t, want_w = _jax_transform(kind)(key, jnp.asarray(clean), jnp.asarray(obf))
    b = upload({"clean": clean[None], "obf": obf[None]}, "cpu", ids=("clean", "obf"))
    got_in, got_t, got_w = SY.apply_synth_transform(spec, jax_synth_draws(key, spec), b["clean"][0], b["obf"][0])
    assert got_in.shape == (*SHAPE, SY.input_channels(nc)) == tuple(want_in.shape)
    np.testing.assert_allclose(got_in.numpy(), np.asarray(want_in), rtol=0, atol=2e-5)
    assert float(got_in.min()) >= 0 and float(got_in.max()) <= 1
    assert sorted(got_t) == sorted(want_t) == ["3d_affs"]
    assert got_t["3d_affs"].shape == (*OUT, 9)
    np.testing.assert_array_equal(got_t["3d_affs"].numpy(), np.asarray(want_t["3d_affs"]))
    np.testing.assert_array_equal(got_w["3d_affs"].numpy(), np.asarray(want_w["3d_affs"]))


def test_gates_both_ways():
    """Over the seeds of the parity test each gated augment applies and is
    skipped, and a section defect is drawn; the port's own draws gate both
    ways too, and only the taken branch draws."""
    spec = SetupSpec(_net_config("3d_affs_from_2d_mtlsd"), VOXEL)
    gates = ("noise", "intensity_channel", "intensity_section", "gamma", "smooth")
    seen = {k: set() for k in gates}
    u = []
    for seed in SEEDS:
        draws = jax_synth_draws(jax.random.PRNGKey(seed), spec)
        for k in gates:
            seen[k].add(k in draws)
        u += draws["defect"]["u"]
    assert all(v == {True, False} for v in seen.values()), seen
    assert min(u) < 0.1  # one section missing or low in contrast
    gen = Generators(0)
    seen = {k: set() for k in gates}
    for _ in range(12):
        draws = SY.draw_synth_transform(gen, spec)
        for k in gates:
            seen[k].add(k in draws)
    assert all(v == {True, False} for v in seen.values())


def test_synth_inputs_refused():
    with pytest.raises(ValueError, match="'raw'"):
        SY.SyntheticTrainingPipeline(get_net_config("3d_affs"), device="cpu")


# -- the pipeline and the workflow ---------------------------------------------


def _train_net_config():
    """3d_affs_from_2d_mtlsd at 2 -> 4 -> 8 channels, two levels."""
    nc = get_net_config("3d_affs_from_2d_mtlsd")
    nc.update(
        num_fmaps=2, fmap_inc_factor=2, input_shape=list(SHAPE),
        downsample_factors=[[1, 2, 2]] * 2,
        kernel_size_down=[[[1, 3, 3], [1, 3, 3]], [[3, 3, 3], [3, 3, 3]], [[3, 3, 3], [3, 3, 3]]],
        kernel_size_up=[[[1, 3, 3], [1, 3, 3]], [[1, 3, 3], [1, 3, 3]]],
    )
    nc["output_shape"] = list(compute_output_shape(unet_config(nc), SHAPE))
    return nc


def test_pipeline_draws_as_jax_on_cpu():
    """One loader thread: the batches hold the pairs the JAX package's
    host draw makes from the same seed, renumbered on the device."""
    nc = _train_net_config()
    pipe = SY.SyntheticTrainingPipeline(nc, VOXEL, batch_size=2, seed=5, device="cpu", num_threads=1, prefetch=1)
    try:
        host = next(pipe.loader)
        batch = pipe.transform_batch(host)
    finally:
        pipe.stop()
    master = np.random.default_rng(5)
    for i in range(2):
        clean, obf = J.synthetic_pair(np.random.default_rng(int(master.integers(0, 2**31))), SHAPE)
        np.testing.assert_array_equal(host["clean"][i], clean.astype(np.uint32))
        np.testing.assert_array_equal(host["obf"][i], obf.astype(np.uint32))
    assert batch["input"].shape == (2, *SHAPE, 12) and batch["input"].dtype == torch.float32
    assert float(batch["input"].min()) >= 0 and float(batch["input"].max()) <= 1
    t = batch["targets"]["3d_affs"]
    assert t.shape == batch["weights"]["3d_affs"].shape == (2, *nc["output_shape"], 9)
    assert set(t.unique().tolist()) <= {0.0, 1.0}


def test_synthetic_setup_trains(tmp_path):
    """A narrow refiner through ``run_training`` with no samples (batch 1,
    learning rate 1e-4): the checkpoint holds the JAX layout, the JAX
    trainer resumes from it, and a second run resumes too."""
    setup = tmp_path / "3d_affs_from_2d_mtlsd"
    setup.mkdir()
    (setup / "net_config.json").write_text(json.dumps(_train_net_config()))
    toml = str(tmp_path / "train.toml")
    tomlio.dump({"train": {"setup_dir": str(setup), "voxel_size": list(VOXEL), "max_iterations": 1,
                           "save_checkpoints_every": 1000, "save_snapshots_every": 0}}, toml)
    out = run_training(toml, device="cpu", compute_dtype=torch.float32)
    assert out["iterations"] == 1 and np.isfinite(out["final_loss"])
    with np.load(out["checkpoint"]) as data:
        assert data["params/unet/l_conv/0/layers/0/w"].shape == (1, 3, 3, 12, 2)
        assert int(data["step"]) == 1
    state = JL.load_checkpoint(out["checkpoint"], optax.adam(1e-4))
    assert int(state.step) == 1
    again = run_training(toml, device="cpu", compute_dtype=torch.float32, max_iterations=2)
    assert again["iterations"] == 2 and again["checkpoint"].endswith("model_checkpoint_2")
