"""Per-section watershed seed maxima.

The contract of the JAX package's Pallas kernels ``ops/pallas_kernels.py:
seed_maxima_3d`` and ``seed_maxima``: for every z-section,
``(dist >= windowmax(dist)) & (mask > 0)`` as uint8, the window spanning
``[-size//2, size-1-size//2]`` along y and x with -inf outside the
section (``scipy.ndimage.maximum_filter(dist, size) == dist``, even sizes
included).

On a CUDA tensor the wrappers launch ``csrc/seed_maxima.cu`` (one launch
per call, counted in ``COUNTS``); on a CPU tensor they run the plain
PyTorch version.  The kernel picks its copy width from the row length and
the distances' address and its body from ``size`` (windows up to 16 keep
the y pass in registers, larger ones take the general body);
``LAST_PLAN`` says what the last launch took.
"""

from __future__ import annotations

import ctypes
import threading

import torch
import torch.nn.functional as F

from . import _build

#: CUDA launches of the seed kernel (added to under ``_COUNT_LOCK``: the
#: blockwise pipelines launch from several threads)
COUNTS = {"kernel": 0}
_COUNT_LOCK = threading.Lock()

#: what the last launch took: bytes per copy of fp32 distances (16, 8 or 4,
#: by the row length and the base address), the body ("registers" or
#: "general") and the output rows a warp walks
LAST_PLAN: dict = {}


def window_lr(size: int):
    """(left, right) reach of scipy's ``maximum_filter`` window."""
    return size // 2, size - 1 - size // 2


def seed_maxima_plain(dist, mask, size: int = 10):
    """Plain PyTorch version: a separable max pool over the -inf-padded
    section, then the >= and mask tests."""
    left, right = window_lr(size)
    d = dist.to(torch.float32).unsqueeze(-3)  # (Z, 1, H, W)
    pad = F.pad(d, (left, right, left, right), value=float("-inf"))
    mx = F.max_pool2d(pad, (size, 1), stride=1)
    mx = F.max_pool2d(mx, (1, size), stride=1).squeeze(-3)
    return ((dist.to(torch.float32) >= mx) & (mask > 0)).to(torch.uint8)


def seed_maxima_3d(dist, mask, size: int = 10):
    """Seeds for a (Z, H, W) stack in one call.  ``mask`` may be bool,
    uint8 or float ({0, 1}); returns uint8 on ``dist``'s device."""
    if dist.dim() != 3 or tuple(mask.shape) != tuple(dist.shape):
        raise ValueError(
            f"expected (Z, H, W) dist and mask, got {tuple(dist.shape)}, "
            f"{tuple(mask.shape)}"
        )
    if size < 1:
        raise ValueError(f"window size must be >= 1, got {size}")
    if not dist.is_cuda:
        return seed_maxima_plain(dist, mask, size)
    return _seed_maxima_cuda(dist, mask, size)


def seed_maxima(dist, mask, size: int = 10):
    """Seeds for one (H, W) section: the Z = 1 case of ``seed_maxima_3d``."""
    if dist.dim() != 2:
        raise ValueError(f"expected (H, W) dist, got {tuple(dist.shape)}")
    return seed_maxima_3d(dist[None], mask[None], size)[0]


def _seed_maxima_cuda(dist, mask, size):
    if dist.dtype != torch.float32:
        raise TypeError(f"seed kernel takes fp32 distances, got {dist.dtype}")
    if mask.device != dist.device:
        raise ValueError("dist and mask must be on one device")
    dist = dist.contiguous()
    if mask.dtype == torch.bool:
        m8 = mask.contiguous().view(torch.uint8)
    elif mask.dtype == torch.uint8:
        m8 = mask.contiguous()
    else:
        m8 = (mask > 0).to(torch.uint8)
    z, h, w = dist.shape
    out = torch.empty((z, h, w), dtype=torch.uint8, device=dist.device)
    if out.numel() == 0:
        return out
    lib = _lib(dist.device)
    plan = (ctypes.c_int * 3)()
    with torch.cuda.device(dist.device):
        stream = torch.cuda.current_stream(dist.device).cuda_stream
        err = lib.bs_seed_maxima(
            dist.data_ptr(), m8.data_ptr(), out.data_ptr(), z, h, w, size, stream, plan
        )
    if err != 0:
        raise RuntimeError(
            f"seed kernel launch failed: cudaError {err} (size {size}, stack {(z, h, w)})"
        )
    count_launch()
    LAST_PLAN.update(
        copy_bytes=4 * plan[0], body="general" if plan[1] else "registers",
        rows_per_warp=plan[2],
    )
    return out


def count_launch() -> None:
    """One more launch of the kernel, from whichever thread."""
    with _COUNT_LOCK:
        COUNTS["kernel"] += 1


_INITIALISED: set = set()


def _lib(device):
    """The built library; on first use per device the general body is given
    the device's opt-in shared memory (once, not per launch)."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib = _build.load(
        "seed_maxima",
        {
            "bs_seed_maxima": ([p, p, p, i, i, i, i, p, ctypes.POINTER(i)], i),
            "bs_seed_maxima_init": ([], i),
        },
    )
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _INITIALISED:
        with torch.cuda.device(index):
            err = lib.bs_seed_maxima_init()
        if err != 0:
            raise RuntimeError(f"seed kernel set-up failed: cudaError {err}")
        _INITIALISED.add(index)
    return lib
