"""bootstrapper_torch seed maxima (K2/K3's Hopper counterpart) against the
JAX package's Pallas kernels (interpret mode on the CPU) and scipy.

All comparisons are exact: the window max and the >= test involve no
rounding.  ``test_torch_kernels_cuda.py`` holds the CUDA kernel against
the plain version on the card.
"""

import numpy as np
import pytest
import torch
from scipy import ndimage

from bootstrapper_torch.ops import seeds as S
from bootstrapper_tpu.ops.pallas_kernels import seed_maxima as jax_seed_maxima
from bootstrapper_tpu.ops.pallas_kernels import seed_maxima_3d as jax_seed_maxima_3d

SIZES = [3, 4, 7, 10]


def _stack(seed, shape=(4, 40, 72)):
    rng = np.random.default_rng(seed)
    dist = rng.uniform(size=shape).astype(np.float32)
    dist[:, ::7, ::5] = 0.5  # plateaus: ties must compare equal
    mask = (rng.uniform(size=shape) > 0.3).astype(np.float32)
    return dist, mask


def _scipy(dist, mask, size):
    return np.stack(
        [
            ((d >= ndimage.maximum_filter(d, size=size)) & (m > 0)).astype(np.uint8)
            for d, m in zip(dist, mask)
        ]
    )


@pytest.mark.parametrize("size", SIZES)
def test_plain_matches_pallas_and_scipy_3d(size):
    dist, mask = _stack(size)
    got = S.seed_maxima_3d(torch.from_numpy(dist), torch.from_numpy(mask), size)
    assert got.dtype == torch.uint8
    got = got.numpy()
    pallas = np.asarray(jax_seed_maxima_3d(dist, mask, size=size, interpret=True))
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, _scipy(dist, mask, size))


@pytest.mark.parametrize("size", SIZES)
def test_single_section_matches_pallas(size):
    """K3: one section is the Z = 1 case of the same function."""
    dist, mask = _stack(10 + size, shape=(1, 33, 70))
    got = S.seed_maxima(torch.from_numpy(dist[0]), torch.from_numpy(mask[0]), size)
    pallas = np.asarray(jax_seed_maxima(dist[0], mask[0], size=size, interpret=True))
    np.testing.assert_array_equal(got.numpy(), pallas)


def test_mask_dtypes_agree():
    dist, mask = _stack(1)
    d = torch.from_numpy(dist)
    outs = [
        S.seed_maxima_3d(d, m, 10)
        for m in (
            torch.from_numpy(mask),
            torch.from_numpy(mask > 0),
            torch.from_numpy((mask > 0).astype(np.uint8)),
        )
    ]
    for o in outs[1:]:
        assert torch.equal(o, outs[0])


def test_rejects_bad_shapes():
    with pytest.raises(ValueError):
        S.seed_maxima_3d(torch.zeros(4, 4), torch.zeros(4, 4))
    with pytest.raises(ValueError):
        S.seed_maxima_3d(torch.zeros(2, 4, 4), torch.zeros(2, 4, 5))
    with pytest.raises(ValueError):
        S.seed_maxima_3d(torch.zeros(2, 4, 4), torch.zeros(2, 4, 4), size=0)
