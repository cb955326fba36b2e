"""bootstrapper_torch ``ops/affinities.py`` against the JAX package's, on
the same numpy label volumes made from a seed: affinity targets, their
mask, boundary growing (with a mask, xy only) and balance weights, all
exact (sums of 0/1 values in fp32 are exact integers)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bootstrapper_torch.ops import affinities as A
from bootstrapper_tpu.ops import affinities as JA

NEIGHBORHOOD = [[-1, 0, 0], [0, -1, 0], [0, 0, -1], [-2, 0, 0], [0, -9, 0], [0, 0, -9], [-3, 0, 0], [0, -27, 0], [0, 0, -27]]
SHAPE = (6, 30, 33)


def _labels(seed, shape=SHAPE, n=12, background=0.2):
    """Blocky labels with background: ids on a coarse grid, upsampled."""
    rng = np.random.default_rng(seed)
    coarse = rng.integers(1, n + 1, (shape[0], -(-shape[1] // 4), -(-shape[2] // 4)))
    lab = np.repeat(np.repeat(coarse, 4, 1), 4, 2)[:, : shape[1], : shape[2]]
    lab[rng.random(shape) < background] = 0
    return lab.astype(np.int32)


def _mask(seed, shape=SHAPE):
    rng = np.random.default_rng(seed + 100)
    m = np.ones(shape, np.uint8)
    m[:, : rng.integers(1, shape[1] // 2)] = 0
    m[rng.random(shape) < 0.05] = 0
    return m


@pytest.mark.parametrize("offset", [(0, 0, 0), (1, 0, 0), (0, -3, 2), (-2, 5, -40), (7, 0, 0)])
def test_shifted_and_in_bounds(offset):
    seg = _labels(0)
    np.testing.assert_array_equal(
        A._shifted(torch.from_numpy(seg), offset, fill=-1).numpy(),
        np.asarray(JA._shifted(jnp.asarray(seg), offset, fill=-1)),
    )
    np.testing.assert_array_equal(
        A._in_bounds(SHAPE, offset).numpy(), np.asarray(JA._in_bounds(SHAPE, offset))
    )


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seg_to_affs_and_mask_exact(seed):
    seg, mask = _labels(seed), _mask(seed)
    got = A.seg_to_affs(torch.from_numpy(seg), NEIGHBORHOOD)
    want = np.asarray(JA.seg_to_affs(jnp.asarray(seg), NEIGHBORHOOD))
    assert got.dtype == torch.float32 and got.shape == (9, *SHAPE)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        A.affs_mask(torch.from_numpy(mask), NEIGHBORHOOD).numpy(),
        np.asarray(JA.affs_mask(jnp.asarray(mask), NEIGHBORHOOD)),
    )


@pytest.mark.parametrize("steps,only_xy,with_mask", [(1, True, True), (1, False, False), (2, True, False), (3, False, True)])
def test_grow_boundary_exact(steps, only_xy, with_mask):
    seg, mask = _labels(steps), _mask(steps)
    m = mask if with_mask else None
    got = A.grow_boundary(
        torch.from_numpy(seg), steps, only_xy, None if m is None else torch.from_numpy(m)
    ).numpy()
    want = np.asarray(JA.grow_boundary(jnp.asarray(seg), steps, only_xy, None if m is None else jnp.asarray(m)))
    np.testing.assert_array_equal(got, want)
    assert (got == 0).sum() > (seg == 0).sum()  # something eroded


def test_grow_boundary_mask_rule():
    """Out-of-mask voxels neither erode nor cause erosion."""
    seg = np.ones((1, 4, 6), np.int32)
    seg[:, :, 3:] = 2
    mask = np.ones_like(seg)
    mask[:, :2, 3] = 0  # one side of the 1|2 border out of the mask in rows 0-1
    got = A.grow_boundary(torch.from_numpy(seg), 1, True, torch.from_numpy(mask)).numpy()
    want = np.asarray(JA.grow_boundary(jnp.asarray(seg), 1, True, jnp.asarray(mask)))
    np.testing.assert_array_equal(got, want)
    assert got[0, 0, 2] == 1 and got[0, 3, 2] == 0


@pytest.mark.parametrize("slab_axis", [None, 0])
@pytest.mark.parametrize("seed", [0, 1])
def test_balance_weights_exact(seed, slab_axis):
    seg, mask = _labels(seed), _mask(seed)
    t = np.array(JA.seg_to_affs(jnp.asarray(seg), NEIGHBORHOOD))
    m = np.array(JA.affs_mask(jnp.asarray(mask), NEIGHBORHOOD))
    got = A.balance_weights(torch.from_numpy(t), torch.from_numpy(m), slab_axis=slab_axis).numpy()
    want = np.asarray(JA.balance_weights(jnp.asarray(t), jnp.asarray(m), slab_axis=slab_axis))
    np.testing.assert_array_equal(got, want)
    # without a mask, and with fractions beyond the clip (an empty channel)
    t[0] = 0
    got = A.balance_weights(torch.from_numpy(t), slab_axis=slab_axis).numpy()
    want = np.asarray(JA.balance_weights(jnp.asarray(t), slab_axis=slab_axis))
    np.testing.assert_array_equal(got, want)
