"""bootstrapper_torch ``ops/lsd.py`` and the 3d_mtlsd model against the JAX
package's, on the CPU in fp32, from the same numpy inputs made from a seed:

- ``gaussian_kernel`` bit-equal; ``calc_max_padding`` equal;
- ``lsd_descriptors`` in 2D and 3D, ``lsd_descriptors_downsampled`` at
  downsample 1 and 2 (odd shapes too), ``lsd_descriptors_2d_stack``, ids
  at and above ``max_labels`` (merged into the last channel): within
  1e-5 (fp32 blurs summed in another order; 1e-6 is read);
- the 3d_mtlsd forward (two heads, the JAX order) within rtol 1e-4, and
  three Adam steps of a narrow 3d_mtlsd on LSD and affinity targets: the
  loss within rtol 1e-4 at each step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bootstrapper_torch.models import Model, init_params_numpy, load_params
from bootstrapper_torch.models import model as M
from bootstrapper_torch.models.unet import compute_output_shape, min_input_shape
from bootstrapper_torch.models.zoo import get_net_config
from bootstrapper_torch.ops import lsd as P
from bootstrapper_torch.ops.affinities import seg_to_affs
from bootstrapper_torch.train import loop as L
from bootstrapper_tpu.models import model as JM
from bootstrapper_tpu.ops import lsd as J
from bootstrapper_tpu.train import loop as JL

ATOL = 1e-5
# compiled once per case: far quicker on the CPU than op by op
J_DOWNSAMPLED = jax.jit(J.lsd_descriptors_downsampled, static_argnames=("sigma", "voxel_size", "downsample", "max_labels"))
J_STACK = jax.jit(J.lsd_descriptors_2d_stack, static_argnames=("sigma", "voxel_size_yx", "max_labels"))


def _voronoi(shape, n, seed, background=0.05, max_id=None):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, 1, (n, len(shape))) * np.array(shape)
    grid = np.stack(np.meshgrid(*[np.arange(s) for s in shape], indexing="ij"), -1)
    aniso = np.array([4.0, 1.0, 1.0][-len(shape):])
    lab = ((((grid[..., None, :] - pts) * aniso) ** 2).sum(-1)).argmin(-1) + 1
    if max_id is not None:
        lab = rng.permutation(np.arange(1, max_id + 1))[:n][lab - 1]
    lab[rng.random(shape) < background] = 0
    return lab.astype(np.int32)


def _close(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("sigma_vox", [0.4, 1.0, 2.0, 10.0, 80 / 6])
@pytest.mark.parametrize("order", [0, 1, 2])
def test_gaussian_kernel_bit_equal(sigma_vox, order):
    got, want = P.gaussian_kernel(sigma_vox, order), J.gaussian_kernel(sigma_vox, order)
    assert got.dtype == want.dtype and np.array_equal(got, want)


LSD_CASES = {
    # shape, cells, sigma (world), voxel size, downsample, max_labels
    "3d": ((5, 16, 18), 10, (80.0, 24.0, 12.0), (40, 4, 4), 1, 64),
    "2d": ((30, 26), 10, 12.0, (4, 4), 1, 64),
    "2d_ds2_odd": ((27, 23), 10, 12.0, (4, 4), 2, 64),
    # ids past max_labels merge into the last channel
    "3d_ds2_odd_ids_above_max_labels": ((5, 19, 17), 30, 40.0, (40, 4, 4), 2, 16),
}


@pytest.mark.parametrize("case", sorted(LSD_CASES))
def test_lsd_descriptors_match_jax(case):
    shape, cells, sigma, vs, ds, max_labels = LSD_CASES[case]
    seg = _voronoi(shape, cells, 1)
    if "max_labels" in case:
        assert seg.max() >= max_labels  # ids merge into the last channel
    got = P.lsd_descriptors_downsampled(seg, sigma, vs, downsample=ds, max_labels=max_labels)
    want = J_DOWNSAMPLED(seg, sigma=sigma, voxel_size=vs, downsample=ds, max_labels=max_labels)
    assert got.shape == (10 if len(shape) == 3 else 6, *shape)
    _close(got, want)
    assert float(got.max()) > 0.5
    if ds == 1:  # background is 0 (downsampled, it takes a neighbour's value)
        _close(P.lsd_descriptors(torch.from_numpy(seg), sigma, vs, max_labels), want)
        assert float(got[:, seg == 0].abs().max()) == 0


def test_lsd_descriptors_2d_stack_match_jax():
    seg = _voronoi((3, 30, 28), 14, 2, max_id=70)
    got = P.lsd_descriptors_2d_stack(seg, 12.0, (4, 4), max_labels=64)
    want = J_STACK(seg, sigma=12.0, voxel_size_yx=(4, 4), max_labels=64)
    assert got.shape == (6, 3, 30, 28)
    _close(got, want)


@pytest.mark.parametrize("output_size,voxel_size,sigma", [((4, 104, 104), (40, 4, 4), 80), ((1, 57, 33), (8, 8, 8), 10)])
def test_calc_max_padding_matches_jax(output_size, voxel_size, sigma):
    assert tuple(P.calc_max_padding(output_size, voxel_size, sigma)) == tuple(
        J.calc_max_padding(output_size, voxel_size, sigma)
    )


# -- 3d_mtlsd: two heads --------------------------------------------------------


def _mtlsd(num_fmaps=3, inc=3):
    """3d_mtlsd, one downsample, 3 -> 9 channels; its smallest tile + 4."""
    nc = get_net_config("3d_mtlsd")
    nc.update(
        num_fmaps=num_fmaps, fmap_inc_factor=inc, downsample_factors=[[1, 2, 2]],
        kernel_size_down=[[[3, 3, 3], [3, 3, 3]]] * 2, kernel_size_up=[[[3, 3, 3], [3, 3, 3]]],
    )
    cfg = M.unet_config(nc)
    nc["input_shape"] = list(min_input_shape(cfg, (12, 24, 24)))
    nc["output_shape"] = list(compute_output_shape(cfg, nc["input_shape"]))
    return nc


def test_mtlsd_forward_matches_jax_fp32():
    nc = _mtlsd()
    jm = JM.Model(nc, compute_dtype=jnp.float32)
    params = init_params_numpy(nc, 1)
    x = np.random.default_rng(0).uniform(-1, 1, (1, *nc["input_shape"], 1)).astype(np.float32)
    want = jax.jit(jm.apply)(params, jnp.asarray(x))
    model = load_params(Model(nc, compute_dtype=torch.float32), params).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    # heads in the net config's order (jit hands back its dict sorted)
    assert list(got) == list(nc["outputs"]) == ["3d_lsds", "3d_affs"] and sorted(want) == sorted(got)
    for k, c in (("3d_lsds", 10), ("3d_affs", 9)):
        assert got[k].shape == (1, *nc["output_shape"], c)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-4, atol=1e-6)


def _mtlsd_batch(nc, seed):
    """A batch with both heads' targets from a Voronoi volume: LSDs (the
    training transform's, at downsample 2) and affinities, weights the
    mask; targets 2 voxels wider in xy than the output (cropped)."""
    rng = np.random.default_rng(seed)
    out = (nc["output_shape"][0], nc["output_shape"][1] + 2, nc["output_shape"][2] + 2)
    seg = torch.from_numpy(_voronoi(out, 8, seed, background=0.1).astype(np.int64))
    lsds = P.lsd_descriptors_downsampled(seg, 80, (40, 4, 4), downsample=2)
    affs = seg_to_affs(seg, nc["outputs"]["3d_affs"]["neighborhood"])
    mask = (rng.random(out) > 0.1).astype(np.float32)
    x = rng.uniform(-1, 1, (1, *nc["input_shape"], 1)).astype(np.float32)

    def last(t):
        return np.ascontiguousarray(np.moveaxis(np.asarray(t, np.float32), 0, -1))[None]

    return {
        "input": x,
        "targets": {"3d_lsds": last(lsds), "3d_affs": last(affs)},
        "weights": {"3d_lsds": last(np.broadcast_to(mask, (10, *out))), "3d_affs": last(np.broadcast_to(mask, (9, *out)))},
    }


def test_mtlsd_train_steps_match_jax():
    nc = _mtlsd()
    lr = 1e-3
    params = init_params_numpy(nc, 0)
    jm = JM.Model(nc, compute_dtype=jnp.float32)

    def jloss(p, batch):
        preds = jm.apply(p, batch["input"])
        t = {k: JL._center_crop_like(batch["targets"][k], preds[k]) for k in preds}
        w = {k: JL._center_crop_like(batch["weights"][k], preds[k]) for k in preds}
        return JM.multi_output_loss(preds, t, w)

    value_and_grad = jax.jit(jax.value_and_grad(jloss))
    tx = optax.adam(lr)
    jparams, opt_state = params, tx.init(params)
    model = load_params(Model(nc, compute_dtype=torch.float32), params)
    state, step = L.TrainState(0, model, L.make_optimizer(model, lr)), L.make_train_step()
    for i in range(3):
        batch = _mtlsd_batch(nc, i)
        want, grads = value_and_grad(jparams, jax.tree_util.tree_map(jnp.asarray, batch))
        updates, opt_state = tx.update(grads, opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        state, out = step(state, jax.tree_util.tree_map(torch.from_numpy, batch))
        np.testing.assert_allclose(float(out["loss"]), float(want), rtol=1e-4)
