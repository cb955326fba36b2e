"""bootstrapper_torch seed maxima (K2/K3's Hopper counterpart) against the
JAX package's Pallas kernels (interpret mode on the CPU) and scipy.

All comparisons are exact: the window max and the >= test involve no
rounding.  ``test_torch_kernels_cuda.py`` holds the CUDA kernel against
the plain version on the card.
"""

import numpy as np
import pytest
import torch
from _torch_seed_cases import EDGE_CASES, scipy_seeds, seed_stack

from bootstrapper_torch.ops import seeds as S
from bootstrapper_tpu.ops.pallas_kernels import seed_maxima as jax_seed_maxima
from bootstrapper_tpu.ops.pallas_kernels import seed_maxima_3d as jax_seed_maxima_3d

SIZES = [3, 4, 7, 10]


def _stack(seed, shape=(4, 40, 72)):
    return seed_stack(seed, shape, "uniform")


@pytest.mark.parametrize(
    "shape,size,kind",
    [pytest.param((4, 40, 72), size, "uniform", id=str(size)) for size in SIZES] + EDGE_CASES,
)
def test_plain_matches_pallas_and_scipy_3d(shape, size, kind):
    dist, mask = seed_stack(size, shape, kind)
    got = S.seed_maxima_3d(torch.from_numpy(dist), torch.from_numpy(mask), size)
    assert got.dtype == torch.uint8 and tuple(got.shape) == shape
    got = got.numpy()
    pallas = np.asarray(jax_seed_maxima_3d(dist, mask, size=size, interpret=True))
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, scipy_seeds(dist, mask, size))


@pytest.mark.parametrize(
    "shape,size,kind",
    [pytest.param((1, 33, 70), size, "uniform", id=str(size)) for size in SIZES]
    + [c for c in EDGE_CASES if c.values[0][1:] in ((33, 70), (20, 5), (4, 4))],
)
def test_single_section_matches_pallas(shape, size, kind):
    """K3: one section is the Z = 1 case of the same function."""
    dist, mask = seed_stack(10 + size, shape, kind)
    dist, mask = dist[-1], mask[-1]
    got = S.seed_maxima(torch.from_numpy(dist), torch.from_numpy(mask), size)
    pallas = np.asarray(jax_seed_maxima(dist, mask, size=size, interpret=True))
    np.testing.assert_array_equal(got.numpy(), pallas)
    np.testing.assert_array_equal(got.numpy(), scipy_seeds(dist[None], mask[None], size)[0])


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
