"""VALID stride-1 3D convolution with fused bias and optional ReLU.

The contract of the JAX package's Pallas kernel ``ops/pallas_conv.py:
pallas_conv3d``: NDHWC input ``(N, D, H, W, Ci)``, DHWIO weights
``(kd, kh, kw, Ci, Co)``, output ``(N, D-kd+1, H-kh+1, W-kw+1, Co)``,
fp32 accumulation, bf16 or fp32 in and out.

Routing (``conv3d``) is decided by shape before any launch:

- shapes ``conv3d_supported`` admits run the hand-written Hopper kernel
  ``csrc/conv3d.cu`` on a CUDA tensor, and its plain PyTorch version
  ``conv3d_plain`` on a CPU tensor;
- every other conv (narrow contractions: the 1-, 12- and 60-channel
  levels) runs ``torch.nn.functional.conv3d``, just as the JAX package
  leaves those shapes to XLA.

``COUNTS`` records each route: ``kernel`` counts CUDA launches only.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

#: route counters: "kernel" (CUDA launches), "plain" (CPU runs of the
#: kernel's plain version), "library" (torch.nn.functional.conv3d)
COUNTS = {"kernel": 0, "plain": 0, "library": 0}

_DTYPES = {torch.bfloat16: 0, torch.float32: 1}


def conv3d_supported(x_shape, w_shape) -> bool:
    """Shapes the kernel takes: any batch, Ci >= 128, a VALID window.

    Admits every shape the Pallas predicate admits (which also demands
    batch 1, bf16 weights <= 6 MB and kw <= 9: limits of the TPU's VMEM
    and DMA window that the Hopper kernel does not have).  Narrower
    contractions would leave most of each 32-channel K chunk empty.
    """
    if len(x_shape) != 5 or len(w_shape) != 5:
        return False
    kd, kh, kw, ci, _ = w_shape
    if x_shape[-1] != ci or ci < 128:
        return False
    d, h, w = x_shape[1:4]
    return d >= kd and h >= kh and w >= kw


def conv3d(x, w, b=None, *, relu: bool = False):
    """Route one conv by shape: the kernel (or, on the CPU, its plain
    version) where ``conv3d_supported`` admits it, else the library."""
    if conv3d_supported(tuple(x.shape), tuple(w.shape)):
        if x.is_cuda:
            return conv3d_cuda(x, w, b, relu=relu)
        COUNTS["plain"] += 1
        return conv3d_plain(x, w, b, relu=relu)
    COUNTS["library"] += 1
    return conv3d_library(x, w, b, relu=relu)


def conv3d_plain(x, w, b=None, *, relu: bool = False):
    """The kernel's arithmetic in plain PyTorch: the sum over kd*kh*kw taps
    of shifted-slice matmuls in fp32, bias and ReLU, one cast at the end."""
    kd, kh, kw, _, co = w.shape
    n, d, h, ww, _ = x.shape
    do, ho, wo = d - kd + 1, h - kh + 1, ww - kw + 1
    xf = x.float()
    wf = w.to(device=x.device, dtype=torch.float32)
    acc = torch.zeros((n, do, ho, wo, co), dtype=torch.float32, device=x.device)
    for dz in range(kd):
        for dy in range(kh):
            for dx in range(kw):
                acc += xf[:, dz : dz + do, dy : dy + ho, dx : dx + wo] @ wf[dz, dy, dx]
    if b is not None:
        acc += b.to(device=x.device, dtype=torch.float32)
    if relu:
        acc.clamp_(min=0)
    return acc.to(x.dtype)


def conv3d_library(x, w, b=None, *, relu: bool = False):
    """``torch.nn.functional.conv3d`` on the same layouts (channels-last
    in and out); the route for shapes the kernel does not take."""
    y = F.conv3d(
        x.permute(0, 4, 1, 2, 3),
        w.to(x.dtype).permute(4, 3, 0, 1, 2),
        None if b is None else b.to(x.dtype),
    )
    if relu:
        y = torch.relu(y)
    return y.permute(0, 2, 3, 4, 1).contiguous()


def _copy_bytes(x) -> int:
    """Widest cp.async copy (16, 8, 4 bytes) that every row start of ``x``
    is aligned to; 2 selects scalar loads (bf16 only)."""
    item = x.element_size()
    offsets = [x.data_ptr()] + [s * item for s in x.stride()[:4]]
    for av in (16, 8, 4):
        if all(o % av == 0 for o in offsets):
            return av
    return 2


def conv3d_cuda(x, w, b=None, *, relu: bool = False):
    """Launch ``csrc/conv3d.cu`` on ``x``'s device and current stream.

    ``x`` may be a strided view (a centre crop) as long as its channel
    stride is 1.  Raises on anything the kernel does not take."""
    if not x.is_cuda:
        raise ValueError("conv3d_cuda needs a CUDA tensor")
    if x.dtype not in _DTYPES:
        raise TypeError(f"conv3d kernel takes bf16 or fp32, got {x.dtype}")
    if x.dim() != 5 or w.dim() != 5:
        raise ValueError(f"expected NDHWC x and DHWIO w, got {x.shape}, {w.shape}")
    if not conv3d_supported(tuple(x.shape), tuple(w.shape)):
        raise ValueError(f"conv3d kernel does not take {tuple(x.shape)} x {tuple(w.shape)}")
    if x.stride(-1) != 1:
        raise ValueError("conv3d kernel needs channel stride 1 (channels-last)")
    if w.device != x.device or (b is not None and b.device != x.device):
        raise ValueError("x, w and b must be on one device")
    kd, kh, kw, ci, co = w.shape
    n, d, h, ww, _ = x.shape
    co_pad = -(-co // 8) * 8
    wk = w.to(x.dtype).reshape(kd * kh * kw * ci, co)
    if co_pad != co:
        wk = F.pad(wk, (0, co_pad - co))
    wk = wk.contiguous()
    bias = None if b is None else b.to(torch.float32).contiguous()
    out = torch.empty(
        (n, d - kd + 1, h - kh + 1, ww - kw + 1, co), dtype=x.dtype, device=x.device
    )
    av = _copy_bytes(x)
    if av == 2 and x.dtype != torch.bfloat16:
        raise ValueError("fp32 input must be 4-byte aligned")
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.bs_conv3d_ndhwc(
            x.data_ptr(), wk.data_ptr(), None if bias is None else bias.data_ptr(),
            out.data_ptr(), _DTYPES[x.dtype], av, n, d, h, ww, ci,
            *x.stride()[:4], kd, kh, kw, co, co_pad, int(relu), stream,
        )
    if err != 0:
        raise RuntimeError(f"conv3d kernel launch failed: cudaError {err}")
    COUNTS["kernel"] += 1
    return out


def _lib():
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    argtypes = [p, p, p, p, i, i, ll, i, i, i, i, ll, ll, ll, ll, i, i, i, i, i, i, p]
    return _build.load("conv3d", {"bs_conv3d_ndhwc": (argtypes, i)})
