"""bootstrapper_torch conv3d (K1's Hopper counterpart) against the JAX
package's Pallas kernel ``pallas_conv3d`` (interpret mode on the CPU).

On the CPU the port runs the kernel's plain version (shifted-slice fp32
matmuls); its contract is the Pallas kernel's, pinned here at the shapes
of ``tests/test_pallas_conv.py`` with the same fp32 tolerance (atol 2e-5).
``test_torch_kernels_cuda.py`` holds the CUDA kernel against the plain
version on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from bootstrapper_torch.models.unet import center_crop
from bootstrapper_torch.ops import conv3d as C
from bootstrapper_tpu.ops.pallas_conv import conv3d_supported as jax_supported
from bootstrapper_tpu.ops.pallas_conv import pallas_conv3d

PALLAS_SHAPES = [
    ((6, 12, 10, 128), (3, 3, 3, 128, 64)),
    ((4, 9, 8, 130), (3, 3, 3, 130, 48)),
    ((3, 6, 7, 128), (1, 3, 3, 128, 128)),
    ((5, 8, 6, 256), (3, 1, 1, 256, 32)),
]


def _inputs(shape, kernel, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((1, *shape)).astype(np.float32)
    w = (rng.standard_normal(kernel) * 0.05).astype(np.float32)
    b = rng.standard_normal(kernel[-1]).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("shape,kernel", PALLAS_SHAPES)
def test_plain_matches_pallas_fp32(shape, kernel, relu):
    x, w, b = _inputs(shape, kernel, 0)
    ref = np.asarray(
        pallas_conv3d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), relu=relu, interpret=True)
    )
    got = C.conv3d_plain(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), relu=relu)
    assert got.shape == ref.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5)


@pytest.mark.parametrize(
    "x_shape,w_shape",
    [((1, *s), k) for s, k in PALLAS_SHAPES]
    + [
        ((1, 6, 12, 10, 48), (3, 3, 3, 48, 48)),  # narrow contraction
        ((2, 6, 12, 10, 128), (3, 3, 3, 128, 64)),  # batch 2
        ((1, 6, 12, 10, 1500), (3, 3, 3, 1500, 1500)),  # 121 MB of weights
        ((1, 6, 12, 10, 128), (3, 3, 11, 128, 64)),  # kw > 9, but W < kw
        ((1, 6, 12, 12, 128), (3, 3, 11, 128, 64)),  # kw > 9
        ((1, 2, 12, 10, 128), (3, 3, 3, 128, 64)),  # D < kd
        ((1, 6, 12, 10, 130), (3, 3, 3, 128, 64)),  # channel mismatch
    ],
)
def test_predicate_admits_every_pallas_shape(x_shape, w_shape):
    """The port's predicate is its own but admits at least every shape the
    Pallas predicate admits; it drops the TPU's VMEM/DMA limits (batch 1,
    6 MB of weights, kw <= 9) and keeps the Ci >= 128 and VALID rules."""
    ours = C.conv3d_supported(x_shape, w_shape)
    if jax_supported(x_shape, w_shape):
        assert ours
    valid = (
        x_shape[-1] == w_shape[3]
        and all(s >= k for s, k in zip(x_shape[1:4], w_shape[:3]))
    )
    assert ours == (valid and w_shape[3] >= 128)


def test_routes_are_counted_and_agree():
    """conv3d picks the route by shape before running: the kernel's plain
    version on the CPU for admitted shapes, F.conv3d for the rest; both
    compute the same conv."""
    rng = np.random.default_rng(3)
    for ci, route in [(128, "plain"), (60, "library")]:
        x = torch.from_numpy(rng.standard_normal((1, 4, 7, 6, ci)).astype(np.float32))
        w = torch.from_numpy((rng.standard_normal((3, 3, 3, ci, 20)) * 0.05).astype(np.float32))
        b = torch.from_numpy(rng.standard_normal(20).astype(np.float32))
        before = dict(C.COUNTS)
        got = C.conv3d(x, w, b, relu=True)
        assert C.COUNTS[route] == before[route] + 1
        assert C.COUNTS["kernel"] == before["kernel"]
        ref = F.conv3d(x.permute(0, 4, 1, 2, 3), w.permute(4, 3, 0, 1, 2), b)
        ref = torch.relu(ref).permute(0, 2, 3, 4, 1)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=2e-5)
        np.testing.assert_allclose(
            C.conv3d_library(x, w, b, relu=True).numpy(), ref.numpy(), atol=2e-5
        )


def test_plain_takes_strided_views():
    """Centre crops reach the conv as strided views (no copy).  The view
    and its contiguous copy are each held to a float64 product over the
    128 channels, within fp32 rounding (rtol 1e-5, atol 1e-6): a
    multi-threaded CPU BLAS may block the two layouts differently, so
    they need not agree bit for bit."""
    rng = np.random.default_rng(4)
    full = torch.from_numpy(rng.standard_normal((1, 8, 11, 10, 128)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((1, 1, 1, 128, 24)) * 0.05).astype(np.float32))
    view = center_crop(full, (4, 7, 6))
    assert not view.is_contiguous()
    want = np.einsum("ndhwc,co->ndhwo", view.numpy().astype(np.float64), w[0, 0, 0].numpy().astype(np.float64))
    for x in (view, view.contiguous()):
        np.testing.assert_allclose(C.conv3d_plain(x, w).numpy(), want, rtol=1e-5, atol=1e-6)


def test_kernel_wrapper_refuses_cpu_tensors():
    x = torch.zeros((1, 3, 3, 3, 128))
    w = torch.zeros((1, 1, 1, 128, 8))
    with pytest.raises(ValueError):
        C.conv3d_cuda(x, w)
