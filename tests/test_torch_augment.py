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
