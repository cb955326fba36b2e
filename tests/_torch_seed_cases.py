"""Inputs for the seed-maxima tests of the port, shared by the CPU parity
tests (``test_torch_seeds.py``) and the CUDA kernel tests
(``test_torch_kernels_cuda.py``).  Imports neither JAX nor torch.

A border that counted as 0 instead of -inf would pass on distances drawn
from uniform(0, 1); the kinds below put negative values, -inf and whole
negative sections on the border.
"""

import numpy as np
import pytest
from scipy import ndimage


def seed_stack(seed, shape, kind="uniform"):
    """``(dist, mask)`` float32 numpy stacks of ``shape`` (Z, H, W).

    kinds: ``uniform`` in [0, 1); ``normal`` (negative values on every
    border); ``negative`` (every value below -1); ``neginf`` (a fifth of
    the entries and the whole first section are -inf); ``crop`` (normal,
    returned as a non-contiguous view of a larger stack).  All but
    ``neginf`` carry plateaus, so ties must compare equal."""
    rng = np.random.default_rng(seed)
    z, h, w = shape
    full = (z, h + 5, w + 3) if kind == "crop" else shape
    if kind == "uniform":
        dist = rng.uniform(size=full).astype(np.float32)
        dist[:, ::7, ::5] = 0.5
    elif kind in ("normal", "crop"):
        dist = rng.normal(size=full).astype(np.float32)
        dist[:, ::7, ::5] = 0.5
    elif kind == "negative":
        dist = (-1.0 - rng.uniform(size=full)).astype(np.float32)
        dist[:, ::7, ::5] = -1.25
    elif kind == "neginf":
        dist = rng.normal(size=full).astype(np.float32)
        dist[rng.uniform(size=full) < 0.2] = -np.inf
        dist[0] = -np.inf
    else:
        raise ValueError(kind)
    mask = (rng.uniform(size=full) > 0.3).astype(np.float32)
    if kind == "crop":
        dist, mask = dist[:, 2:-3, 1:-2], mask[:, 2:-3, 1:-2]
        assert not dist.flags["C_CONTIGUOUS"]
    return dist, mask


def scipy_seeds(dist, mask, size):
    return np.stack(
        [
            ((d >= ndimage.maximum_filter(d, size=size)) & (m > 0)).astype(np.uint8)
            for d, m in zip(dist, mask)
        ]
    )


def _case(shape, size, kind):
    return pytest.param(shape, size, kind, id=f"{'x'.join(map(str, shape))}-s{size}-{kind}")


# windows up to 16 keep their y pass in registers on the card, larger ones
# take the general body: 16 | 17 is that limit
EDGE_CASES = [
    *[_case((3, 33, 70), size, "normal") for size in (1, 2, 16, 17, 33)],
    *[_case((2, 40, 72), size, "negative") for size in (7, 10, 17)],
    *[_case((2, 40, 72), size, "neginf") for size in (10, 33)],
    # H or W smaller than the window
    _case((2, 5, 70), 10, "normal"),
    _case((2, 40, 3), 10, "normal"),
    _case((2, 4, 4), 17, "normal"),
    _case((1, 1, 1), 10, "normal"),
    # every alignment class of rows: 16-, 8- and 4-byte row starts
    *[_case((3, 20, w), size, "normal") for w in (1, 2, 3, 5, 70, 1250) for size in (10, 17)],
    # a cropped view, which the wrapper makes contiguous
    *[_case((3, 33, 70), size, "crop") for size in (10, 33)],
]
