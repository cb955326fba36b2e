"""Dynamic int8 convolution (inference only, ``BS_INT8=1``): the JAX
package's ``ops/quant.py``.

An H100 runs dense s8 x s8 -> s32 products at 1979 TOPS against 989
TFLOP/s in bf16 (NVIDIA's data sheet, SXM, 700 W), so on a conv-bound graph
int8 is the one lever past the bf16 rate that leaves the model as it is.
The default stays bf16.

Scheme, the JAX package's arithmetic exactly: symmetric dynamic
quantization, no calibration pass.

- Activations: one scale per tensor, ``sx = max(amax|x|, 1e-30) / 127`` in
  fp32, taken over whatever tensor the graph hands to the conv (a part of
  a channel concat on its own, a residual's input before its centre crop:
  ``qconv``'s ``scale_of``).
- Weights: one scale per output channel, the max over every other axis,
  over 127.
- ``q = clip(round(v / s), -127, 127)``: division (not a reciprocal
  product), ties to even.
- int32 accumulation; ``acc * (sx * sw)`` in fp32, then the bias and the
  ReLU, cast to the compute dtype once.  (The JAX package casts before it
  adds the bias; in fp32 that is the same, in bf16 one rounding apart.)

Routing (``qconv``), decided by the tensor's device before any launch: a
CUDA tensor runs ``qconv_cuda``, the hand-written kernels of
``csrc/qconv3d.cu`` (K4: the activation's amax, its quantization into s8
channels padded to the conv's pitch, and an ``mma.sync`` s8 implicit-GEMM
conv with the rescale fused), a CPU tensor the plain version
``qconv_plain``: ``F.conv3d`` in float64 on the integer-valued tensors,
which is exact (every partial sum stays below 2^53), then the same rescale.

``COUNTS["kernel"]`` counts ``qconv_cuda`` calls (each launches the three
kernels once); ``KERNEL_LAUNCHES`` splits them by conv shape.  Gradients of
round and clip are zero, so the U-Net takes this route only with grad
disabled and training ignores the flag.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
import threading

import torch
import torch.nn.functional as F

from . import _build
from .conv3d import empty_channels_last

#: route counters: "kernel" (``qconv_cuda`` calls), "plain" (CPU runs of
#: ``qconv_plain``), "pack" (weights quantized and packed)
COUNTS = {"kernel": 0, "plain": 0, "pack": 0}

#: ``qconv_cuda`` calls by conv: (x shape, w shape) -> count
KERNEL_LAUNCHES: dict = {}

_LOCK = threading.Lock()

BK = 64  # the kernel's K chunk in bytes: K is padded to it


def int8_enabled() -> bool:
    """``BS_INT8=1`` switches the convs to int8, as in the JAX package."""
    return os.environ.get("BS_INT8", "0") == "1"


def int8_active() -> bool:
    """The flag, where it applies: inference, with grad disabled."""
    return int8_enabled() and not torch.is_grad_enabled()


def _over_127(t):
    """``t / 127`` by IEEE division on every device: PyTorch's CUDA division
    by a Python number multiplies by its reciprocal, which can land one ulp
    from the quotient that the JAX package (and the kernel) compute."""
    return t / torch.full((), 127.0, device=t.device)


def activation_scale(x) -> torch.Tensor:
    """``max(amax|x|, 1e-30) / 127``: an fp32 scalar on ``x``'s device."""
    return _over_127(torch.clamp(x.abs().amax().float(), min=1e-30))


def _round_clip(v) -> torch.Tensor:
    return torch.clamp(torch.round(v), -127, 127).to(torch.int8)


def quantize(x, sx=None):
    """``(xq, sx)``: ``x`` (any shape) as int8 with one scale ``sx``, by
    default ``activation_scale(x)``."""
    if sx is None:
        sx = activation_scale(x)
    return _round_clip(x.float() / sx), sx


def quantize_weights(w):
    """``(wq, sw)`` of DHWIO weights: one scale per output channel."""
    wf = w.float()
    sw = _over_127(torch.clamp(wf.abs().amax(dim=tuple(range(w.dim() - 1))), min=1e-30))
    return _round_clip(wf / sw), sw


def channel_pitch(ci: int) -> tuple:
    """``(Cp, vec)``: the kernel's channel pitch for ``ci`` input channels
    and its copy width; each tap's channels are padded to ``Cp``, so that a
    copy never crosses a tap (16-byte copies from 32 channels on, where the
    padding costs at most a fifth; 4-byte ones below)."""
    vec = 16 if ci >= 32 else 4
    return -(-ci // vec) * vec, vec


@dataclasses.dataclass(frozen=True)
class QuantizedWeights:
    """One conv's int8 weights: ``wq`` DHWIO int8, ``sw`` (Co,) fp32, and
    ``data``, the kernel's layout: ``(Co, Kp)`` int8 with ``k = tap * Cp +
    c``, zero past Ci in each tap and past the taps, ``Kp`` a multiple of
    ``BK``."""

    wq: torch.Tensor
    sw: torch.Tensor
    data: torch.Tensor
    cp: int
    vec: int

    @property
    def shape(self) -> tuple:
        return tuple(self.wq.shape)


def pack_qweights(w) -> QuantizedWeights:
    """Quantize DHWIO weights (any channel slice, any strides, fp32 or
    bf16) and pack them for the kernel; counted in ``COUNTS['pack']``."""
    COUNTS["pack"] += 1
    wq, sw = quantize_weights(w)
    kd, kh, kw, ci, co = wq.shape
    cp, vec = channel_pitch(ci)
    taps = kd * kh * kw
    kp = -(-taps * cp // BK) * BK
    data = torch.zeros((co, kp), dtype=torch.int8, device=wq.device)
    rows = torch.zeros((taps, cp, co), dtype=torch.int8, device=wq.device)
    rows[:, :ci] = wq.reshape(taps, ci, co)
    data[:, : taps * cp] = rows.reshape(taps * cp, co).t()
    return QuantizedWeights(wq, sw, data, cp, vec)


def qconv(x, w, b=None, *, relu: bool = False, out_dtype=None, qw=None, scale_of=None):
    """``conv_valid(x, w) (+ b) (ReLU)`` in int8: NDHWC ``x``, DHWIO ``w``,
    output in ``out_dtype`` (default ``x``'s).  ``qw`` is
    ``pack_qweights(w)`` as the caller keeps it (made here without it);
    ``scale_of`` is the tensor whose amax sets ``x``'s scale (default
    ``x``; a residual passes its input before the centre crop).  The route
    is the tensor's device: the kernels on a CUDA tensor, the plain version
    on a CPU one."""
    out_dtype = x.dtype if out_dtype is None else out_dtype
    if qw is None:
        qw = pack_qweights(w)
    if x.is_cuda:
        return qconv_cuda(x, qw, b, relu=relu, out_dtype=out_dtype, scale_of=scale_of)
    COUNTS["plain"] += 1
    sx = None if scale_of is None else activation_scale(scale_of)
    return qconv_plain(x, w, b, relu=relu, out_dtype=out_dtype, qw=qw, sx=sx)


def qconv_plain(x, w, b=None, *, relu: bool = False, out_dtype=torch.bfloat16, qw=None, sx=None):
    """The kernels' arithmetic in plain PyTorch: ``quantize`` (with ``sx``
    if given), the s8 products summed exactly by ``F.conv3d`` in float64,
    then ``acc * (sx * sw)`` in fp32, the bias, the ReLU, one cast."""
    xq, sx = quantize(x, sx)
    wq, sw = quantize_weights(w) if qw is None else (qw.wq, qw.sw)
    acc = F.conv3d(
        xq.to(torch.float64).permute(0, 4, 1, 2, 3),
        wq.to(device=x.device, dtype=torch.float64).permute(4, 3, 0, 1, 2),
    ).permute(0, 2, 3, 4, 1)
    y = acc.to(torch.float32) * (sx * sw.to(x.device))
    if b is not None:
        y = y + b.to(device=x.device, dtype=torch.float32)
    if relu:
        y = y.clamp_(min=0)
    return y.to(out_dtype)


def qconv_cuda(x, qw: QuantizedWeights, b=None, *, relu: bool = False, out_dtype=torch.bfloat16,
               scale_of=None):
    """Launch ``csrc/qconv3d.cu`` on ``x``'s device and current stream: the
    amax of ``scale_of`` (default ``x``), ``x`` quantized into s8 at the
    channel pitch of ``qw``, the s8 conv with the rescale, bias and ReLU
    fused.  ``x`` (and ``scale_of``) may be strided views with channel
    stride 1, bf16 or fp32; the output (bf16 or fp32) is laid out by
    ``empty_channels_last``.  No host synchronisation.  Raises on anything
    the kernels do not take."""
    if not x.is_cuda:
        raise ValueError("qconv_cuda needs a CUDA tensor")
    src = x if scale_of is None else scale_of
    for t in (x, src):
        if t.dim() != 5 or t.stride(-1) != 1:
            raise ValueError(f"qconv kernel needs NDHWC tensors with channel stride 1, got {t.shape}")
        if t.dtype not in (torch.bfloat16, torch.float32):
            raise TypeError(f"qconv kernel takes bf16 or fp32 activations, got {t.dtype}")
        if t.device != x.device:
            raise ValueError("x and scale_of must be on one device")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"qconv kernel writes bf16 or fp32, not {out_dtype}")
    kd, kh, kw, ci, co = qw.shape
    n, d, h, ww, cx = x.shape
    if cx != ci or d < kd or h < kh or ww < kw:
        raise ValueError(f"qconv kernel does not take {tuple(x.shape)} x {qw.shape}")
    if src.shape[-1] != ci:
        raise ValueError("scale_of must have x's channels")
    if qw.data.device != x.device or (b is not None and b.device != x.device):
        raise ValueError("x, the packed weights and b must be on one device")
    lib = _lib()
    dev = x.device
    bias = None if b is None else b.to(torch.float32).contiguous()
    out = empty_channels_last((n, d - kd + 1, h - kh + 1, ww - kw + 1, co), out_dtype, dev)
    amax = torch.zeros((), dtype=torch.int32, device=dev)
    sx = torch.empty((), dtype=torch.float32, device=dev)
    xq = torch.empty((n, d, h, ww, qw.cp), dtype=torch.int8, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.bs_s8_amax(
            src.data_ptr(), int(src.dtype == torch.bfloat16), *src.shape, *src.stride()[:4],
            amax.data_ptr(), stream,
        )
        if err == 0:
            err = lib.bs_s8_quantize(
                x.data_ptr(), int(x.dtype == torch.bfloat16), *x.shape, *x.stride()[:4], qw.cp,
                amax.data_ptr(), sx.data_ptr(), xq.data_ptr(), stream,
            )
        if err == 0:
            err = lib.bs_qconv3d(
                xq.data_ptr(), qw.data.data_ptr(), sx.data_ptr(), qw.sw.data_ptr(),
                None if bias is None else bias.data_ptr(), out.data_ptr(),
                int(out_dtype == torch.bfloat16), n, d, h, ww, qw.cp, qw.vec, kd, kh, kw, co,
                qw.data.shape[1], out.stride(3), int(relu), stream,
            )
    if err != 0:
        raise RuntimeError(f"qconv kernel launch failed: cudaError {err}")
    key = (tuple(x.shape), qw.shape)
    with _LOCK:
        COUNTS["kernel"] += 1
        KERNEL_LAUNCHES[key] = KERNEL_LAUNCHES.get(key, 0) + 1
    return out


def _lib():
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    tensor = [p, i, i, i, i, i, i, ll, ll, ll, ll]
    return _build.load(
        "qconv3d",
        {
            "bs_s8_amax": ([*tensor, p, p], i),
            "bs_s8_quantize": ([*tensor, i, p, p, p, p], i),
            "bs_qconv3d": ([p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, i, i, i, ll, i, p], i),
            "bs_qconv3d_kernel_info": ([i, ctypes.POINTER(i)], i),
        },
    )


def kernel_info() -> list:
    """Per conv kernel instantiation of ``csrc/qconv3d.cu``: copy width,
    output dtype, registers per thread, static shared memory and local
    (spill) bytes, from ``cudaFuncGetAttributes``."""
    lib = _lib()
    rows, info, index = [], (ctypes.c_int * 5)(), 0
    while True:
        err = lib.bs_qconv3d_kernel_info(index, info)
        if err == -1:
            return rows
        if err != 0:
            raise RuntimeError(f"cudaFuncGetAttributes failed: cudaError {err}")
        vec, bf16, regs, static, local = info
        rows.append({
            "vec": vec, "out": "bf16" if bf16 else "fp32", "registers": regs,
            "static_smem": static, "local_bytes": local,
        })
        index += 1
