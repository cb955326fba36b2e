"""bootstrapper_torch ``pipeline/augment.py`` against the JAX package's.

``jax.random`` and ``torch.Generator`` never give the same numbers, so each
augment is held in two parts:

- its *apply*: the JAX function's draws are recomputed here from the key
  splits the JAX function makes, fed to the port's apply, and the results
  compared (1e-5; labels exactly, except where a sampling coordinate lies
  within float noise of a half voxel, where rounding may go either way);
  the cubic resize's weight matrices bit for bit, its product within 1e-6
  of the float64 product (``jax.image.resize`` itself is up to 4.9e-6 off
  it, so the two are held to 1e-5);
- its *draw*: by range and by moments over many draws.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.image.scale import _fill_keys_cubic_kernel, compute_weight_mat

from bootstrapper_torch.pipeline import augment as A
from bootstrapper_tpu.pipeline import augment as JA

SHAPE = (6, 40, 40)


def _raw(seed, shape=SHAPE):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _split(key, n):
    return list(jax.random.split(key, n))


# -- apply, given the JAX draws ---------------------------------------------


@pytest.mark.parametrize("seed", range(2))
def test_simple_apply_matches_jax(seed):
    key = jax.random.PRNGKey(seed)
    raw = _raw(seed)
    lab = np.random.default_rng(seed).integers(0, 9, SHAPE).astype(np.int32)
    want = JA.simple_augment(key, {"raw": jnp.asarray(raw), "labels": jnp.asarray(lab)}, mirror_axes=(0, 1, 2), transpose_axes=(1, 2))
    km, kt = _split(key, 2)
    flips = [bool(f) for f in np.asarray(jax.random.bernoulli(km, 0.5, (3,)))]
    do_t = bool(jax.random.bernoulli(kt, 0.5))
    got = A.apply_simple({"raw": _t(raw), "labels": _t(lab)}, flips, do_t, mirror_axes=(0, 1, 2), transpose_axes=(1, 2))
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("m,n", [(5, 24), (8, 196), (12, 5)])
def test_cubic_weight_matrix_equals_jax(m, n):
    """Bit for bit the matrix ``jax.image.scale_and_translate`` builds (the
    last case downsamples: antialiased kernel)."""
    want = np.asarray(compute_weight_mat(m, n, n / m, 0.0, _fill_keys_cubic_kernel, True))
    np.testing.assert_array_equal(A.resize_matrix(m, n, "cubic").numpy(), want)


@pytest.mark.parametrize(
    "src,dst", [((3, 5, 8, 8), (3, 24, 40, 40)), ((2, 3, 4, 7), (2, 9, 4, 30)), ((1, 9, 12), (1, 4, 5))]
)
def test_cubic_resize_matches_jax_image_resize(src, dst):
    """Within 1e-6 of the float64 product of those matrices; within 1e-5 of
    ``jax.image.resize``, whose own fp32 einsum is up to 4.9e-6 from that
    product on unit normal inputs."""
    x = np.random.default_rng(0).standard_normal(src).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), dst, method="cubic"))
    exact = x.astype(np.float64)
    for d, (m, n) in enumerate(zip(src, dst)):
        if m != n:
            w = np.asarray(compute_weight_mat(m, n, n / m, 0.0, _fill_keys_cubic_kernel, True), np.float64)
            exact = np.moveaxis(np.moveaxis(exact, d, -1) @ w, -1, d)
    got = A.resize(_t(x), dst, "cubic").numpy()
    np.testing.assert_allclose(got, exact, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("seed", range(2))
def test_flow_apply_matches_jax(seed):
    key = jax.random.PRNGKey(seed)
    cs, js, rot, sr = (8, 32, 32), (0.0, 2.0, 2.0), np.pi / 2, (0.9, 1.1)
    want = np.asarray(JA._sample_flow(key, SHAPE, cs, js, rot, sr))
    kj, kr, ks = _split(key, 3)
    noise = np.asarray(jax.random.normal(kj, (3, *A.control_shape(SHAPE, cs))))
    angle = float(jax.random.uniform(kr, (), minval=-rot, maxval=rot))
    scale = float(jax.random.uniform(ks, (), minval=sr[0], maxval=sr[1]))
    got = A.apply_flow(SHAPE, js, _t(noise), angle, scale).numpy()
    # flows reach ~30 voxels: a few fp32 ulps of that
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def _elastic_draws(key, shape):
    kj, kr, ks = _split(key, 3)
    return {
        "noise": _t(jax.random.normal(kj, (3, *A.control_shape(shape, (8, 32, 32))))),
        "angle": float(jax.random.uniform(kr, (), minval=-np.pi / 2, maxval=np.pi / 2)),
        "scale": float(jax.random.uniform(ks, (), minval=0.9, maxval=1.1)),
    }


@pytest.mark.parametrize("seed", range(3))
def test_elastic_apply_matches_jax(seed):
    key = jax.random.PRNGKey(seed)
    rng = np.random.default_rng(seed)
    raw = _raw(seed)
    lab = np.repeat(rng.integers(0, 50, (6, 10, 40)), 4, axis=1).astype(np.int32)
    mask = (rng.random(SHAPE) > 0.3).astype(np.float32)
    arrays = {"raw": raw, "labels": lab, "mask": mask}
    interp = {"raw": 1, "labels": 0, "mask": 0}
    want = JA.elastic_deform(key, {k: jnp.asarray(v) for k, v in arrays.items()}, interp)
    flow = A.apply_flow(SHAPE, (0.0, 2.0, 2.0), **_elastic_draws(key, SHAPE))
    got = A.apply_elastic({k: _t(v) for k, v in arrays.items()}, interp, flow)
    np.testing.assert_allclose(got["raw"].numpy(), np.asarray(want["raw"]), rtol=0, atol=1e-5)
    # nearest: equal wherever no coordinate is within float noise of x.5
    coords = np.stack(np.meshgrid(*[np.arange(s, dtype=np.float32) for s in SHAPE], indexing="ij"))
    coords = coords + np.asarray(JA._sample_flow(key, SHAPE, (8, 32, 32), (0.0, 2.0, 2.0), np.pi / 2, (0.9, 1.1)))
    tie = (np.abs(np.abs(coords - np.floor(coords)) - 0.5) < 1e-4).any(0)
    assert tie.mean() < 1e-2
    for k in ("labels", "mask"):
        differ = got[k].numpy() != np.asarray(want[k])
        assert not (differ & ~tie).any(), k


def test_map_linear_nearest_matches_jax():
    """Coordinates inside, outside and on the edges of the array."""
    rng = np.random.default_rng(0)
    x = rng.random((5, 7, 9), dtype=np.float32)
    coords = [rng.uniform(-3, s + 2, (4, 6, 8)).astype(np.float32) for s in x.shape]
    coords[1][0, 0] = [0, 6, 6.5, -0.5, 7, 3, 3, 3]
    want = np.asarray(jax.scipy.ndimage.map_coordinates(jnp.asarray(x), [jnp.asarray(c) for c in coords], order=1, mode="nearest"))
    got = A.map_linear_nearest(_t(x), [_t(c) for c in coords]).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_noise_apply_matches_jax():
    key, raw = jax.random.PRNGKey(0), _raw(0)
    want = np.asarray(JA.noise_augment(key, jnp.asarray(raw), 0.05))
    k1, k2 = _split(key, 2)
    sigma = float(jax.random.uniform(k1, (), maxval=0.05))
    noise = _t(jax.random.normal(k2, SHAPE))
    np.testing.assert_allclose(A.apply_noise(_t(raw), sigma, noise).numpy(), want, rtol=0, atol=1e-5)


def test_intensity_apply_matches_jax():
    key, raw = jax.random.PRNGKey(1), _raw(1)
    want = np.asarray(JA.intensity_augment(key, jnp.asarray(raw), slab_axis=0))
    scale, shift = [], []
    for k in _split(key, SHAPE[0]):
        k1, k2 = _split(k, 2)
        scale.append(float(jax.random.uniform(k1, (), minval=0.9, maxval=1.1)))
        shift.append(float(jax.random.uniform(k2, (), minval=-0.1, maxval=0.1)))
    got = A.apply_intensity(_t(raw), torch.tensor(scale), torch.tensor(shift), slab_axis=0).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("slab_axis", [0, None])
def test_gamma_apply_matches_jax(slab_axis):
    key, raw = jax.random.PRNGKey(3), _raw(3)
    want = np.asarray(JA.gamma_augment(key, jnp.asarray(raw), slab_axis=slab_axis))
    lo, hi = np.log(0.8), np.log(1.25)
    if slab_axis is None:
        lg = float(jax.random.uniform(key, (), minval=lo, maxval=hi))
    else:
        lg = torch.tensor([float(jax.random.uniform(k, (), minval=lo, maxval=hi)) for k in _split(key, SHAPE[0])])
    got = A.apply_gamma(_t(raw), lg, slab_axis=slab_axis).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_impulse_apply_matches_jax():
    key, raw = jax.random.PRNGKey(4), _raw(4)
    want = np.asarray(JA.impulse_noise_augment(key, jnp.asarray(raw), 0.05))
    k1, k2 = _split(key, 2)
    hit = _t(jax.random.bernoulli(k1, 0.05, SHAPE))
    vals = _t(jax.random.uniform(k2, SHAPE))
    np.testing.assert_array_equal(A.apply_impulse(_t(raw), hit, vals).numpy(), want)


@pytest.mark.parametrize("seed", range(2))
def test_smooth_apply_matches_jax(seed):
    shape = (12, 30, 30)  # enough slabs that some fall under sigma 0.05
    key, raw = jax.random.PRNGKey(seed), _raw(seed, shape)
    want = np.asarray(JA.smooth_augment(key, jnp.asarray(raw)))
    sigma = torch.tensor([float(jax.random.uniform(k, (), minval=0.0, maxval=1.5)) for k in _split(key, shape[0])])
    got = A.apply_smooth(_t(raw), sigma, slab_axis=0).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("sigma", [0.0, 0.7, 2.5])
def test_gaussian_blur_matches_jax(sigma):
    raw = _raw(5, (4, 11, 13))
    want = np.asarray(JA._gaussian_blur_fixed_radius(jnp.asarray(raw), jnp.float32(sigma), 4))
    got = A._gaussian_blur_fixed_radius(_t(raw), sigma, 4).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("artifact,with_mask", [(False, False), (True, False), (True, True)])
def test_defect_apply_matches_jax(artifact, with_mask):
    shape = (40, 12, 12)  # enough sections for every kind of defect
    key, raw = jax.random.PRNGKey(6), _raw(6, shape)
    rng = np.random.default_rng(7)
    art = rng.random(shape, dtype=np.float32) if artifact else None
    art_mask = (rng.random(shape) > 0.5).astype(np.float32) if with_mask else None
    probs = dict(prob_missing=0.2, prob_low_contrast=0.3, prob_artifact=0.3 if artifact else 0.0)
    want = np.asarray(
        JA.defect_augment(
            key, jnp.asarray(raw), **probs,
            artifact=None if art is None else jnp.asarray(art),
            artifact_mask=None if art_mask is None else jnp.asarray(art_mask),
        )
    )
    kd, _, _, kb = _split(key, 4)
    u = np.asarray(jax.random.uniform(kd, (shape[0],))).tolist()
    alpha = np.asarray(jax.random.uniform(kb, (shape[0], 1, 1), minval=0.3, maxval=0.9)).ravel().tolist()
    got = A.apply_defect(
        _t(raw), u, alpha, **probs,
        artifact=None if art is None else _t(art),
        artifact_mask=None if art_mask is None else _t(art_mask),
    ).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert (got != raw).any(axis=(1, 2)).sum() >= 10


# -- draws: range and moments ------------------------------------------------


def test_draws_range_and_moments():
    gen = A.Generators(0)
    coins = [gen.coin(0.5) for _ in range(4000)]
    assert abs(np.mean(coins) - 0.5) < 0.03
    flows = [A.draw_flow(gen, (32, 196, 196), (8, 32, 32), np.pi / 2, (0.9, 1.1)) for _ in range(400)]
    angles = np.array([f["angle"] for f in flows])
    scales = np.array([f["scale"] for f in flows])
    assert angles.min() >= -np.pi / 2 and angles.max() < np.pi / 2 and abs(angles.mean()) < 0.15
    assert scales.min() >= 0.9 and scales.max() < 1.1 and abs(scales.mean() - 1.0) < 0.01
    assert flows[0]["noise"].shape == (3, 5, 8, 8)
    noise = torch.stack([f["noise"] for f in flows])
    assert abs(float(noise.mean())) < 0.01 and abs(float(noise.std()) - 1) < 0.01

    slab = torch.empty((32, 1, 1))
    inten = A.draw_intensity(gen, slab)
    assert inten["scale"].shape == (32,) and 0.9 <= float(inten["scale"].min()) and float(inten["scale"].max()) < 1.1
    assert -0.1 <= float(inten["shift"].min()) and float(inten["shift"].max()) < 0.1
    lg = torch.cat([A.draw_gamma(gen, slab, slab_axis=0)["log_gamma"] for _ in range(100)])
    assert float(lg.min()) >= np.log(0.8) and float(lg.max()) < np.log(1.25) and abs(float(lg.mean())) < 0.01
    sig = torch.cat([A.draw_smooth(gen, slab)["sigma"] for _ in range(100)])
    assert float(sig.min()) >= 0 and float(sig.max()) < 1.5 and abs(float(sig.mean()) - 0.75) < 0.03
    imp = A.draw_impulse(gen, (64, 64, 64), 0.05)
    assert abs(float(imp["hit"].float().mean()) - 0.05) < 0.002
    assert abs(float(imp["values"].mean()) - 0.5) < 0.005
    nz = A.draw_noise(gen, (64, 64, 64), 0.05)
    assert 0 <= nz["sigma"] < 0.05 and abs(float(nz["noise"].std()) - 1) < 0.01
    d = A.draw_defect(gen, 5000)
    assert abs(np.mean(d["u"]) - 0.5) < 0.02 and 0.3 <= min(d["alpha"]) and max(d["alpha"]) < 0.9


def test_public_augments_run_and_keep_shape():
    gen = A.Generators(1)
    raw = _t(_raw(1))
    lab = torch.randint(0, 5, SHAPE, dtype=torch.int32)
    out = A.simple_augment(gen, {"raw": raw, "labels": lab}, transpose_axes=(1, 2))
    out = A.elastic_deform(gen, out, {"raw": 1, "labels": 0})
    assert out["labels"].dtype == torch.int32 and set(out["labels"].unique().tolist()) <= set(range(5))
    x = out["raw"]
    for fn in (A.noise_augment, A.intensity_augment, A.gamma_augment, A.impulse_noise_augment, A.smooth_augment, A.defect_augment):
        x = fn(gen, x)
        assert x.shape == SHAPE and x.dtype == torch.float32
        assert float(x.min()) >= 0 and float(x.max()) <= 1


# -- fold, CLAHE and the label ops ----------------------------------------------


def _fold_draws(key, n, prob, max_strength):
    """``fold_augment``'s draws from its key."""
    kz, ka, kp, ks = _split(key, 4)
    return {
        "do": [bool(d) for d in np.asarray(jax.random.bernoulli(kz, prob, (n,)))],
        "angle": np.asarray(jax.random.uniform(ka, (n,), maxval=np.pi)).tolist(),
        "offset": np.asarray(jax.random.uniform(kp, (n,), minval=0.25, maxval=0.75)).tolist(),
        "strength": np.asarray(jax.random.uniform(ks, (n,), minval=1.0, maxval=max_strength)).tolist(),
    }


@pytest.mark.parametrize("seed", range(2))
def test_fold_apply_matches_jax(seed):
    """At a fold probability of 0.5, so that sections fold and others not."""
    key = jax.random.PRNGKey(seed)
    raw = _raw(seed, (6, 40, 36))
    want = np.asarray(JA.fold_augment(key, jnp.asarray(raw), prob=0.5, max_strength=6.0, width=8.0))
    draws = _fold_draws(key, 6, 0.5, 6.0)
    assert 0 < sum(draws["do"]) < 6
    got = A.apply_fold(_t(raw), **draws, width=8.0).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    moved = (np.abs(got - raw) > 1e-3).any(axis=(1, 2))
    assert moved.tolist() == draws["do"]


def _clahe_raw(seed):
    """Sections with values on every bin edge (``i / 128``, 0 and 1), values
    outside [0, 1], a near-empty section (mean under ``signal_min``) and one
    that is nearly constant."""
    rng = np.random.default_rng(seed)
    raw = rng.random((6, 24, 24), dtype=np.float32)
    edges = (np.arange(129, dtype=np.float32) / np.float32(128)).astype(np.float32)
    raw[0].flat[: edges.size] = edges
    raw[1].flat[:40] = rng.choice([-0.25, -1e-3, 1.0 + 1e-3, 1.5, 0.0, 1.0], 40)
    raw[2] = 0.0
    raw[2, :3, :3] = rng.random((3, 3))
    raw[3] = 0.5
    raw[3, 0, :5] = edges[[0, 64, 127, 128, 63]]
    raw[4] = raw[4] ** 4  # most of the mass in the low bins
    return raw


@pytest.mark.parametrize("nbins", [128, 100])
def test_clahe_apply_matches_jax(nbins):
    key = jax.random.PRNGKey(nbins)
    raw = _clahe_raw(nbins)
    want = np.asarray(JA.clahe_augment(key, jnp.asarray(raw), clip_range=(0.6, 1.0), nbins=nbins, signal_min=0.05))
    clip = [float(jax.random.uniform(k, (), minval=0.6, maxval=1.0)) for k in _split(key, 6)]
    got = A.apply_clahe(_t(raw), clip, nbins=nbins, signal_min=0.05).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got[2], raw[2])  # under signal_min: untouched
    assert not np.allclose(got[0], raw[0])


def test_histogram_bins_as_jnp_histogram():
    """Bin counts equal to ``jnp.histogram``'s on the edges themselves: left-
    closed bins, the last closed on both sides, values outside dropped."""
    raw = _clahe_raw(0)
    for nbins in (128, 100, 7):
        edges = jnp.linspace(0.0, 1.0, nbins + 1)
        want = np.stack([np.asarray(jnp.histogram(jnp.asarray(s), bins=edges)[0]) for s in raw])
        got = A._histogram(_t(raw.reshape(6, -1)), nbins).numpy()
        np.testing.assert_array_equal(got, want)


def test_mix_u32_matches_jax_on_all_32_bits():
    ids = np.array([0, 1, 63, 64, 2**31 - 1, 2**31, 2**31 + 12345, 2**32 - 1, 0xDEADBEEF], np.uint32)
    ids = np.concatenate([ids, np.random.default_rng(0).integers(0, 2**32, 1000, dtype=np.uint64).astype(np.uint32)])
    want = np.asarray(JA._mix_u32(jnp.asarray(ids)))
    got = A._mix_u32(torch.from_numpy(ids.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


def _many_labels(seed, shape):
    """Cubes of 2x4x4 voxels, over 64 labels, ids 2**31 and above."""
    rng = np.random.default_rng(seed)
    n = (shape[0] // 2) * (shape[1] // 4) * (shape[2] // 4)
    ids = rng.choice(np.arange(2**31, 2**31 + 10 * n, 10, dtype=np.uint64), n, replace=False).astype(np.uint32)
    ids[rng.random(n) < 0.1] = 0  # some background
    blocks = ids.reshape(shape[0] // 2, shape[1] // 4, shape[2] // 4)
    return np.kron(blocks, np.ones((2, 4, 4), np.uint32)).astype(np.uint32)


@pytest.mark.parametrize("seed,only_xy", [(0, True), (1, False)])
def test_random_grow_boundary_apply_matches_jax(seed, only_xy):
    key = jax.random.PRNGKey(seed)
    lab = _many_labels(seed, (6, 40, 40))
    assert len(np.unique(lab)) > 64 and lab.max() >= 2**31
    want = np.asarray(JA.random_grow_boundary(key, jnp.asarray(lab), max_steps=3, only_xy=only_xy))
    s = int(jax.random.randint(key, (), 0, np.iinfo(np.int32).max, dtype=jnp.int32))
    got = A.apply_grow_boundary(torch.from_numpy(lab.astype(np.int64)), s, max_steps=3, only_xy=only_xy).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))
    assert (got == 0).sum() > (lab == 0).sum()


@pytest.mark.parametrize("dims", [2, 3])
@pytest.mark.parametrize("expansion", range(4))
def test_expand_labels_and_create_mask_match_jax(dims, expansion):
    rng = np.random.default_rng(dims * 10 + expansion)
    shape = (4, 20, 20)[-dims:]
    lab = rng.integers(1, 7, shape).astype(np.int32)
    lab[rng.random(shape) < 0.7] = 0
    want = np.asarray(JA.expand_labels(jnp.asarray(lab), expansion))
    got = A.expand_labels(_t(lab), expansion).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32 and (expansion == 0) == (got == lab).all()
    mask = A.create_mask(_t(got))
    assert mask.dtype == torch.uint8
    np.testing.assert_array_equal(mask.numpy(), np.asarray(JA.create_mask(jnp.asarray(want))))


def test_new_draws_and_public_augments():
    gen = A.Generators(2)
    fold = A.draw_fold(gen, 4000, prob=0.25, max_strength=6.0)
    assert abs(np.mean(fold["do"]) - 0.25) < 0.03
    assert 0 <= min(fold["angle"]) and max(fold["angle"]) < np.pi
    assert 0.25 <= min(fold["offset"]) and max(fold["offset"]) < 0.75
    assert 1.0 <= min(fold["strength"]) and max(fold["strength"]) < 6.0
    clip = A.draw_clahe(gen, 4000)["clip"]
    assert 0.6 <= min(clip) and max(clip) < 1.0 and abs(np.mean(clip) - 0.8) < 0.01
    seeds = [A.draw_grow_boundary(gen)["seed"] for _ in range(200)]
    assert 0 <= min(seeds) and max(seeds) < 2**31 - 1 and len(set(seeds)) == 200
    raw = _t(_raw(2))
    for out in (A.fold_augment(gen, raw, prob=0.5), A.clahe_augment(gen, raw)):
        assert out.shape == SHAPE and out.dtype == torch.float32 and torch.isfinite(out).all()
    lab = torch.from_numpy(_many_labels(2, SHAPE).astype(np.int64))
    grown = A.random_grow_boundary(gen, lab)
    assert grown.shape == lab.shape and ((grown == 0) | (grown == lab)).all()
