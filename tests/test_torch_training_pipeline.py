"""bootstrapper_torch ``pipeline/training.py`` and ``train/sampler.py``
against the JAX package's, on the same numpy inputs made from a seed:

- renumbering, raw normalisation and id folding: exact;
- the host samplers: the same crops from the same Zarr and seed;
- the whole device transform, given the draws the JAX transform makes from
  its key: the net input within 2e-5 (raw within 1e-5, times 2), targets
  and weights exactly (unless
  a sampling coordinate of the deform lies within float noise of a half
  voxel, where the nearest label may differ);
- the pipeline end to end on the CPU: shapes, dtypes, value ranges.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bootstrapper_torch.core import arrays as A
from bootstrapper_torch.core.geometry import Coordinate
from bootstrapper_torch.models.zoo import get_net_config
from bootstrapper_torch.pipeline import augment as AUG
from bootstrapper_torch.pipeline import training as T
from bootstrapper_torch.train import sampler as S
from bootstrapper_tpu.core.arrays import open_ds as jax_open_ds
from bootstrapper_tpu.pipeline import augment as JAUG
from bootstrapper_tpu.pipeline import training as JT
from bootstrapper_tpu.train import sampler as JS

VOXEL = (40, 4, 4)


def _net_config(tile=(8, 40, 40), out=(4, 20, 20)):
    nc = get_net_config("3d_affs")
    nc.update(input_shape=list(tile), output_shape=list(out))
    return nc


def _voronoi(shape, n, seed, background=0.15):
    """Voronoi labels (anisotropic z) with background: large uint64 ids."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, 1, (n, 3)) * np.array(shape)
    grid = np.stack(np.meshgrid(*[np.arange(s) for s in shape], indexing="ij"), -1)
    d = (((grid[..., None, :] - pts) * np.array([4.0, 1.0, 1.0])) ** 2).sum(-1)
    ids = rng.integers(1, 2**40, n).astype(np.uint64)
    lab = ids[d.argmin(-1)]
    lab[rng.random(shape) < background] = 0
    return lab


# -- deterministic pieces ------------------------------------------------------


@pytest.mark.parametrize(
    "case", ["with_background", "no_background", "over_64_ids", "large_uint32_ids"]
)
def test_device_renumber_exact(case):
    rng = np.random.default_rng(0)
    shape = (4, 20, 20)
    if case == "over_64_ids":
        lab = rng.integers(0, 300, shape).astype(np.uint32)
    elif case == "large_uint32_ids":
        lab = rng.choice(np.array([0, 5, 2**31 - 1, 2**31, 2**32 - 1], np.uint32), shape)
    else:
        lab = rng.integers(0 if case == "with_background" else 3, 40, shape).astype(np.uint32)
    want = np.asarray(JT.device_renumber(jnp.asarray(lab)))
    got = T.device_renumber(T.upload({"labels": lab[None]}, "cpu")["labels"][0])
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.float32])
def test_device_normalize_raw_exact(dtype):
    raw = (np.random.default_rng(1).random((3, 9, 9)) * (200 if dtype != np.float32 else 1)).astype(dtype)
    np.testing.assert_array_equal(
        T.device_normalize_raw(torch.from_numpy(raw)).numpy(),
        np.asarray(JT.device_normalize_raw(jnp.asarray(raw))),
    )


def test_host_helpers_exact():
    lab = _voronoi((3, 12, 12), 9, 0)
    lab[0, 0, :3] = [2**32 + 2**32 * 7, (5 << 32) | 5, 7]  # folds to 0 -> remapped
    np.testing.assert_array_equal(S.fold_ids_u32(lab), JS.fold_ids_u32(lab))
    small = lab % 1000
    for max_labels in (None, 5):
        np.testing.assert_array_equal(S.renumber(small, max_labels), JS.renumber(small, max_labels))
    raw = np.arange(256, dtype=np.uint8).reshape(4, 64)
    np.testing.assert_array_equal(S.normalize_raw(raw), JS.normalize_raw(raw))


@pytest.fixture(scope="module")
def sample_paths(tmp_path_factory):
    """A sample (raw, labels, mask) and an artifact pair as uncompressed Zarr
    written by the port."""
    work = tmp_path_factory.mktemp("sample")
    shape = (12, 64, 64)
    rng = np.random.default_rng(3)
    data = {
        "raw": rng.integers(0, 256, shape, dtype=np.uint8),
        "labels": _voronoi(shape, 30, 3),
        "mask": (rng.random(shape) > 0.1).astype(np.uint8),
        "artifacts": rng.integers(0, 256, (10, 50, 50), dtype=np.uint8),
        "artifacts_mask": (rng.random((10, 50, 50)) > 0.5).astype(np.uint8),
    }
    paths = {}
    for name, a in data.items():
        paths[name] = str(work / "s.zarr" / name)
        ds = A.prepare_ds(paths[name], a.shape, (0, 0, 0), VOXEL, a.dtype, chunk_shape=(4, 32, 32))
        ds[ds.roi] = a
    return paths


def test_samplers_cut_the_jax_crops(sample_paths):
    p = sample_paths
    tile = Coordinate((8, 40, 40)) * Coordinate(VOXEL)
    port = S.RandomLocationSampler([S.Sample.open(p["raw"], p["labels"], p["mask"])], tile, tile, min_masked=0.5, seed=7)
    ref = JS.RandomLocationSampler(
        [JS.Sample(jax_open_ds(p["raw"]), jax_open_ds(p["labels"]), jax_open_ds(p["mask"]))], tile, tile,
        min_masked=0.5, seed=7,
    )
    for _ in range(4):
        got, want = port.sample(), ref.sample()
        assert (tuple(got["roi"].offset), tuple(got["roi"].shape)) == (tuple(want["roi"].offset), tuple(want["roi"].shape))
        for k in ("raw", "labels", "mask"):
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    art = S.ArtifactSampler.open([{"artifacts": p["artifacts"], "artifacts_mask": p["artifacts_mask"]}], (8, 40, 40), seed=2)
    jart = JS.ArtifactSampler([(jax_open_ds(p["artifacts"]), jax_open_ds(p["artifacts_mask"]))], (8, 40, 40), seed=2)
    for _ in range(3):
        got, want = art.sample(), jart.sample()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


# -- the whole transform, given JAX's draws ------------------------------------


def jax_transform_draws(key, spec):
    """The draws ``make_device_transform``'s transform makes from ``key``,
    split as it splits them, in the port's form."""
    keys = jax.random.split(key, 12)
    shape = spec.input_tile
    z = shape[0]

    def coin(k):
        return bool(jax.random.bernoulli(k, 0.5))

    def per_slab(k, lo, hi):
        return torch.tensor([float(jax.random.uniform(kk, (), minval=lo, maxval=hi)) for kk in jax.random.split(k, z)])

    km, kt = jax.random.split(keys[0])
    draws = {
        "simple": {
            "flips": [bool(f) for f in np.asarray(jax.random.bernoulli(km, 0.5, (3,)))],
            "transpose": coin(kt),
        }
    }
    if coin(keys[2]):
        kj, kr, ks = jax.random.split(keys[1], 3)
        draws["deform"] = {
            "noise": torch.from_numpy(np.array(jax.random.normal(kj, (3, *AUG.control_shape(shape, T.CONTROL_SPACING))))),
            "angle": float(jax.random.uniform(kr, (), minval=-np.pi / 2, maxval=np.pi / 2)),
            "scale": float(jax.random.uniform(ks, (), minval=0.9, maxval=1.1)),
        }
    if coin(keys[5]):
        k1, k2 = jax.random.split(keys[5])
        draws["noise"] = {
            "sigma": float(jax.random.uniform(k1, (), maxval=0.05)),
            "noise": torch.from_numpy(np.array(jax.random.normal(k2, shape))),
        }
    if coin(keys[6]):
        scale, shift = [], []
        for k in jax.random.split(keys[6], z):
            k1, k2 = jax.random.split(k)
            scale.append(float(jax.random.uniform(k1, (), minval=0.9, maxval=1.1)))
            shift.append(float(jax.random.uniform(k2, (), minval=-0.1, maxval=0.1)))
        draws["intensity"] = {"scale": torch.tensor(scale), "shift": torch.tensor(shift)}
    if coin(keys[7]):
        draws["gamma"] = {"log_gamma": per_slab(keys[7], np.log(0.8), np.log(1.25))}
    if coin(keys[8]):
        k1, k2 = jax.random.split(keys[8])
        draws["impulse"] = {
            "hit": torch.from_numpy(np.array(jax.random.bernoulli(k1, 0.05, shape))),
            "values": torch.from_numpy(np.array(jax.random.uniform(k2, shape))),
        }
    if coin(keys[9]):
        draws["smooth"] = {"sigma": per_slab(keys[9], 0.0, 1.5)}
    kd, _, _, kb = jax.random.split(keys[10], 4)
    draws["defect"] = {
        "u": np.asarray(jax.random.uniform(kd, (z,))).tolist(),
        "alpha": np.asarray(jax.random.uniform(kb, (z, 1, 1), minval=0.3, maxval=0.9)).ravel().tolist(),
    }
    return draws


def _deform_ties(key, spec):
    """Whether any sampling coordinate of the transform's deform lies
    within float noise of a half voxel."""
    shape = spec.input_tile
    keys = jax.random.split(key, 12)
    flow = np.asarray(JAUG._sample_flow(keys[1], shape, T.CONTROL_SPACING, T.JITTER_SIGMA, np.pi / 2, (0.9, 1.1)))
    grid = np.stack(np.meshgrid(*[np.arange(s, dtype=np.float32) for s in shape], indexing="ij"))
    c = grid + flow
    return bool((np.abs(np.abs(c - np.floor(c)) - 0.5) < 1e-4).any())


@pytest.mark.parametrize("seed", range(10))  # seeds 3, 6, 7 and 8 deform
def test_device_transform_matches_jax_given_its_draws(seed):
    nc = _net_config()
    spec_p, spec_j = T.SetupSpec(nc, VOXEL), JT.SetupSpec(nc, VOXEL)
    shape = spec_p.input_tile
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 256, shape, dtype=np.uint8)
    labels = S.fold_ids_u32(_voronoi(shape, 25, seed))
    mask = (rng.random(shape) > 0.05).astype(np.uint8)
    mask[:, :4] = 0
    key = jax.random.PRNGKey(seed)
    want_in, want_t, want_w = JT.make_device_transform(spec_j)(key, jnp.asarray(raw), jnp.asarray(labels), jnp.asarray(mask))
    draws = jax_transform_draws(key, spec_p)
    b = T.upload({"raw": raw[None], "labels": labels[None], "mask": mask[None]}, "cpu")
    got_in, got_t, got_w = T.apply_transform(spec_p, draws, b["raw"][0], b["labels"][0], b["mask"][0])
    assert got_in.shape == (*shape, 1) and got_t["3d_affs"].shape == (*spec_p.output_tile, 9)
    # raw within 1e-5, scaled by 2 into the net input
    np.testing.assert_allclose(got_in.numpy(), np.asarray(want_in), rtol=0, atol=2e-5)
    exact = all(
        np.array_equal(got[k].numpy(), np.asarray(want[k])) for got, want in ((got_t, want_t), (got_w, want_w)) for k in want
    )
    assert exact or ("deform" in draws and _deform_ties(key, spec_p))


def test_batch_transform_and_gates():
    """Batch of two through the public transform; every gate both ways
    over a few draws; only the taken branch draws."""
    nc = _net_config()
    spec = T.SetupSpec(nc, VOXEL)
    gen = AUG.Generators(0)
    seen = {k: set() for k in ("deform", "noise", "intensity", "gamma", "impulse", "smooth")}
    for _ in range(12):
        draws = T.draw_transform(gen, spec)
        for k in seen:
            seen[k].add(k in draws)
    assert all(v == {True, False} for v in seen.values())
    rng = np.random.default_rng(0)
    shape = spec.input_tile
    batch = T.upload(
        {
            "raw": rng.integers(0, 256, (2, *shape), dtype=np.uint8),
            "labels": np.stack([S.fold_ids_u32(_voronoi(shape, 20, s)) for s in (0, 1)]),
            "mask": np.ones((2, *shape), np.uint8),
        },
        "cpu",
    )
    out = T.make_batch_transform(spec)(gen, batch["raw"], batch["labels"], batch["mask"])
    assert out["input"].shape == (2, *shape, 1)
    assert float(out["input"].min()) >= -1 and float(out["input"].max()) <= 1
    t, w = out["targets"]["3d_affs"], out["weights"]["3d_affs"]
    assert t.shape == w.shape == (2, *spec.output_tile, 9)
    assert set(t.unique().tolist()) <= {0.0, 1.0} and float(w.min()) >= 0 and float(t.sum()) > 0


def test_pipeline_end_to_end_on_cpu(sample_paths):
    p = sample_paths
    nc = _net_config()
    samples = [S.Sample.open(p["raw"], p["labels"], p["mask"])]
    arts = [(A.open_ds(p["artifacts"]), A.open_ds(p["artifacts_mask"]))]
    pipe = T.TrainingPipeline(nc, VOXEL, samples, artifact_samples=arts, prob_artifact=0.5, device="cpu", num_threads=1, prefetch=2)
    try:
        for _ in range(2):
            b = pipe.next_batch()
            assert b["input"].shape == (1, 8, 40, 40, 1) and b["input"].dtype == torch.float32
            assert b["targets"]["3d_affs"].shape == (1, 4, 20, 20, 9)
    finally:
        pipe.stop()


def test_setups_of_each_kind_transform():
    """A 2D setup (2d_mtlsd at a small tile), an LSD one and 3d_mtlsd all
    build a transform that gives their heads' targets: the 2D one at batch
    10 and learning rate 1e-4, on ``adj_slices`` sections, with the
    neighbourhood given a z of 0 and 2D targets of the centre section."""
    nc2 = get_net_config("2d_mtlsd")
    nc2.update(input_shape=[60, 60], output_shape=[24, 24])
    gen = AUG.Generators(0)
    rng = np.random.default_rng(0)
    for nc, heads in (
        (nc2, {"2d_lsds": (24, 24, 6), "2d_affs": (24, 24, 6)}),
        ({**_net_config(), "outputs": {"lsd": {"dims": 10, "sigma": 80}}}, {"lsd": (4, 20, 20, 10)}),
        (_mtlsd_net_config(), {"3d_lsds": (4, 20, 20, 10), "3d_affs": (4, 20, 20, 9)}),
    ):
        spec = T.SetupSpec(nc, VOXEL)
        shape = spec.input_tile
        b = T.upload(
            {
                "raw": rng.integers(0, 256, (1, *shape), dtype=np.uint8),
                "labels": S.fold_ids_u32(_voronoi(shape, 12, 0))[None],
                "mask": np.ones((1, *shape), np.uint8),
            },
            "cpu",
        )
        net_in, targets, _ = T.make_device_transform(spec)(gen, b["raw"][0], b["labels"][0], b["mask"][0])
        assert net_in.shape == (*shape, 1)
        assert {k: tuple(v.shape) for k, v in targets.items()} == heads
    spec = T.SetupSpec(nc2, VOXEL)
    assert (spec.input_tile, spec.output_tile, spec.batch_size, spec.learning_rate) == ((3, 60, 60), (1, 24, 24), 10, 1e-4)
    assert spec.output_spec("2d_affs")["neighborhood"][:2] == [[0, -1, 0], [0, 0, -1]]


def _mtlsd_net_config(tile=(8, 40, 40), out=(4, 20, 20)):
    nc = get_net_config("3d_mtlsd")
    nc.update(input_shape=list(tile), output_shape=list(out))
    return nc


@pytest.mark.parametrize("seed", [0, 3, 6])  # 3 and 6 deform
def test_mtlsd_transform_matches_jax_given_its_draws(seed):
    """Both heads of 3d_mtlsd from the JAX transform's draws: the LSD
    targets (fp32 blurs summed in another order) within 1e-5, their
    weights (the mask) and the affinity head exactly, unless a deform
    sample lies on a half voxel."""
    nc = _mtlsd_net_config()
    spec_p, spec_j = T.SetupSpec(nc, VOXEL), JT.SetupSpec(nc, VOXEL)
    shape = spec_p.input_tile
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 256, shape, dtype=np.uint8)
    labels = S.fold_ids_u32(_voronoi(shape, 25, seed))
    mask = (rng.random(shape) > 0.05).astype(np.uint8)
    mask[:, :4] = 0
    key = jax.random.PRNGKey(seed)
    _, want_t, want_w = JT.make_device_transform(spec_j)(key, jnp.asarray(raw), jnp.asarray(labels), jnp.asarray(mask))
    draws = jax_transform_draws(key, spec_p)
    b = T.upload({"raw": raw[None], "labels": labels[None], "mask": mask[None]}, "cpu")
    _, got_t, got_w = T.apply_transform(spec_p, draws, b["raw"][0], b["labels"][0], b["mask"][0])
    assert sorted(got_t) == sorted(want_t) == ["3d_affs", "3d_lsds"]
    assert got_t["3d_lsds"].shape == got_w["3d_lsds"].shape == (*spec_p.output_tile, 10)
    lsd_close = np.abs(got_t["3d_lsds"].numpy() - np.asarray(want_t["3d_lsds"])).max() <= 1e-5
    exact = all(np.array_equal(got[k].numpy(), np.asarray(want[k]))
                for got, want in ((got_t, want_t), (got_w, want_w)) for k in ("3d_affs",))
    exact &= np.array_equal(got_w["3d_lsds"].numpy(), np.asarray(want_w["3d_lsds"]))
    assert (exact and lsd_close) or ("deform" in draws and _deform_ties(key, spec_p))
    assert float(got_t["3d_lsds"].max()) > 0
