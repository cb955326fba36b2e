"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card.  Every case carries the ``cuda`` marker and skips without a GPU.
This file imports no JAX, so it also runs on the GPU host:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda -q
"""

import numpy as np
import pytest
import torch
from scipy import ndimage

from bootstrapper_torch.models.unet import center_crop
from bootstrapper_torch.ops import conv3d as C
from bootstrapper_torch.ops import seeds as S


@pytest.fixture
def cuda():
    """The CUDA device, or a skip: decided when the test runs, never at
    import or collection time, so every worker collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m cuda on the GPU host)")
    return torch.device("cuda")


CUDA_CASES = [
    # (x shape, w shape, dtype, crop): each cp.async width and the scalar
    # path (AV 16/8/4/2), a strided crop, batch 2, Cout not a multiple of 8
    ((1, 5, 9, 10, 128), (3, 3, 3, 128, 64), torch.float32, None),
    ((1, 4, 9, 8, 130), (3, 3, 3, 130, 48), torch.float32, None),
    ((1, 5, 9, 10, 128), (3, 3, 3, 128, 64), torch.bfloat16, None),
    ((1, 6, 11, 9, 300), (3, 3, 3, 300, 60), torch.bfloat16, None),
    ((1, 4, 9, 8, 129), (3, 3, 3, 129, 70), torch.bfloat16, None),
    ((2, 5, 7, 9, 1500), (1, 1, 1, 1500, 300), torch.bfloat16, None),
    ((1, 8, 12, 12, 300), (3, 3, 3, 300, 300), torch.bfloat16, (6, 9, 9)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("x_shape,w_shape,dtype,crop", CUDA_CASES)
def test_conv3d_kernel_matches_plain(cuda, x_shape, w_shape, dtype, crop, relu):
    """fp32: FMAs in another order (atol 1e-4 at outputs of O(5)); bf16:
    one rounding of fp32 sums taken in another order (rtol = atol = 2^-6,
    about two bf16 ulps)."""
    gen = torch.Generator(device="cpu").manual_seed(0)
    x = torch.randn(x_shape, generator=gen).to(cuda, dtype)
    if crop is not None:
        x = center_crop(x, crop)
    fan_in = w_shape[0] * w_shape[1] * w_shape[2] * w_shape[3]
    w = (torch.randn(w_shape, generator=gen) / fan_in**0.5).to(cuda, dtype)
    b = torch.randn(w_shape[-1], generator=gen).to(cuda, dtype)
    before = C.COUNTS["kernel"]
    got = C.conv3d(x, w, b, relu=relu)
    torch.cuda.synchronize()
    assert C.COUNTS["kernel"] == before + 1
    ref = C.conv3d_plain(x, w, b, relu=relu)
    tol = 1e-4 if dtype == torch.float32 else 2.0**-6
    np.testing.assert_allclose(
        got.float().cpu().numpy(), ref.float().cpu().numpy(), rtol=tol, atol=tol
    )


def _stack(seed, shape):
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


@pytest.mark.cuda
@pytest.mark.parametrize("size", [3, 4, 7, 10, 11, 33])
@pytest.mark.parametrize("shape", [(3, 33, 70), (8, 640, 640)])
def test_seed_kernel_matches_plain(cuda, shape, size):
    dist, mask = _stack(size, shape)
    d = torch.from_numpy(dist).to(cuda)
    m = torch.from_numpy(mask > 0).to(cuda)
    before = S.COUNTS["kernel"]
    got = S.seed_maxima_3d(d, m, size)
    assert S.COUNTS["kernel"] == before + 1
    assert torch.equal(got, S.seed_maxima_plain(d, m, size))
    np.testing.assert_array_equal(got.cpu().numpy(), _scipy(dist, mask, size))
