"""VALID stride-1 3D convolution with fused bias and optional ReLU.

The contract of the JAX package's Pallas kernel ``ops/pallas_conv.py:
pallas_conv3d``: NDHWC input ``(N, D, H, W, Ci)``, DHWIO weights
``(kd, kh, kw, Ci, Co)``, output ``(N, D-kd+1, H-kh+1, W-kw+1, Co)``,
fp32 accumulation, bf16 or fp32 in and out.

Routing (``conv3d``) is decided by shape and dtype before any launch:

- shapes ``conv3d_supported`` admits run the hand-written Hopper kernels
  of ``csrc/conv3d.cu`` on a CUDA tensor (bf16: ``wgmma`` from swizzled
  shared memory behind an mbarrier ring, fed by TMA where the input's
  voxels start on 16-byte lines; fp32: exact FMAs), and the plain PyTorch
  version ``conv3d_plain`` on a CPU tensor;
- every other conv (narrow contractions: the 1-, 12- and 60-channel
  levels) runs ``torch.nn.functional.conv3d``, just as the JAX package
  leaves those shapes to XLA.

With grad enabled, a kernel-route conv goes through ``Conv3dFunction``: its
forward is the kernel (on the CPU the plain version) and its backward
gives dX, dW and db through ``aten.convolution_backward`` (the products
``torch.nn.grad.conv3d_input`` / ``conv3d_weight`` compute).  The JAX
package has no backward kernel for its Pallas conv: it trains through
XLA's own conv gradients.  ``conv3d_cuda`` itself gives no gradient and
raises where autograd would need one.

The kernels read weights in their own layout (``pack_weights``): the
callers that own parameters pack once (the U-Net keeps the packed form
beside each conv's parameter) and hand it over where the kernel launches; a
call without it packs on the spot.  ``tile_plan`` is the host side of the bf16 kernel: the tile
width fitted to Co, the K walk, the ring depth.  Outputs are laid out by
``empty_channels_last``, which the U-Net's other ops use too, so that a
kernel's input always has its voxels on 16-byte lines.

``COUNTS`` records each route: ``kernel`` counts CUDA launches only, and
``KERNEL_LAUNCHES`` splits them by conv shape.
"""

from __future__ import annotations

import ctypes
import dataclasses
import threading

import torch
import torch.nn.functional as F

from . import _build

#: route counters: "kernel" (CUDA launches), "plain" (CPU runs of the
#: kernel's plain version), "library" (torch.nn.functional.conv3d),
#: "pack" (calls of ``pack_weights``)
COUNTS = {"kernel": 0, "plain": 0, "library": 0, "pack": 0}

#: CUDA launches by conv: (x shape, w shape) -> count, incremented where
#: ``COUNTS["kernel"]`` is and reset with it (``ops.reset_launch_counts``)
KERNEL_LAUNCHES: dict = {}

#: guards the kernel counts and the per-device set-up, which devices driven
#: from several threads would otherwise update at once
_LOCK = threading.Lock()

#: the bf16 kernel's instantiated tile widths BN -> rows BM of the CTA tile
#: (two consumer warpgroups of BM/2 rows each); as in csrc/conv3d.cu
TILE_WIDTHS = {64: 256, 152: 256, 256: 128}
CHUNK = 64  # channels per K chunk: one 128-byte swizzled row of bf16
ROW_BYTES = 128
MAX_STAGES = 8
SMEM_OPTIN = 232448  # bytes of shared memory one block can opt in to (H100)


def conv3d_supported(x_shape, w_shape) -> bool:
    """Shapes the kernel takes: any batch, Ci >= 128, a VALID window.

    Admits every shape the Pallas predicate admits (which also demands
    batch 1, bf16 weights <= 6 MB and kw <= 9: limits of the TPU's VMEM
    and DMA window that the Hopper kernel does not have).  Narrower
    contractions would leave most of each 64-channel K chunk empty.
    """
    if len(x_shape) != 5 or len(w_shape) != 5:
        return False
    kd, kh, kw, ci, _ = w_shape
    if x_shape[-1] != ci or ci < 128:
        return False
    d, h, w = x_shape[1:4]
    return d >= kd and h >= kh and w >= kw


def conv3d(x, w, b=None, *, relu: bool = False, pack=None):
    """Route one conv by shape: the kernel (or, on the CPU, its plain
    version) where ``conv3d_supported`` admits it, else the library.
    ``pack()`` gives ``pack_weights(w, x.dtype)`` as the caller keeps it; it
    is called only where the kernel launches."""
    if conv3d_supported(tuple(x.shape), tuple(w.shape)):
        if torch.is_grad_enabled():
            return Conv3dFunction.apply(x, w, b, relu, pack)
        if x.is_cuda:
            packed = None if pack is None else pack()
            return conv3d_cuda(x, w, b, relu=relu, packed=packed)
        COUNTS["plain"] += 1
        return conv3d_plain(x, w, b, relu=relu)
    COUNTS["library"] += 1
    return conv3d_library(x, w, b, relu=relu)


class Conv3dFunction(torch.autograd.Function):
    """K1 with a gradient: ``apply(x, w, b, relu, pack)``.

    Forward: ``conv3d_cuda`` on a CUDA tensor, ``conv3d_plain`` on a CPU
    tensor (counted as ``conv3d`` counts them), its output in the layout
    of ``empty_channels_last`` on both, as a tensor that is no view, so
    that the U-Net may add to it in place.  ``w`` is the parameter (or a
    channel slice of it) in its own dtype, cast to ``x``'s for the
    product; the gradients come back in the inputs' dtypes.  Backward: dX
    and dW in ``x``'s dtype from one ``aten.convolution_backward`` (cuDNN
    on the card), db as an fp32 sum; where ReLU was fused, the saved
    output masks the incoming gradient first."""

    @staticmethod
    def forward(ctx, x, w, b, relu, pack):
        if x.is_cuda:
            out = conv3d_cuda(x, w, b, relu=relu, packed=None if pack is None else pack())
        else:
            COUNTS["plain"] += 1
            y = conv3d_plain(x, w, b, relu=relu)
            out = empty_channels_last(tuple(y.shape), y.dtype, y.device)
            out.copy_(y)
        out = _not_a_view(out)
        ctx.relu = relu
        ctx.b_dtype = None if b is None else b.dtype
        ctx.save_for_backward(x, w, out if relu else None)
        return out

    @staticmethod
    def backward(ctx, g):
        x, w, out = ctx.saved_tensors
        if out is not None:
            g = g.masked_fill(out <= 0, 0)
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        dx = dw = db = None
        if need_x or need_w:
            gn = g.to(x.dtype).permute(0, 4, 1, 2, 3)
            wn = w.to(x.dtype).permute(4, 3, 0, 1, 2)
            dxn, dwn, _ = torch.ops.aten.convolution_backward(
                gn, x.permute(0, 4, 1, 2, 3), wn, None,
                [1, 1, 1], [0, 0, 0], [1, 1, 1], False, [0, 0, 0], 1,
                [need_x, need_w, False],
            )
            if need_x:
                dx = dxn.permute(0, 2, 3, 4, 1)
            if need_w:
                dw = dwn.permute(2, 3, 4, 1, 0).to(w.dtype)
        if need_b and ctx.b_dtype is not None:
            db = g.float().sum((0, 1, 2, 3)).to(ctx.b_dtype)
        return dx, dw, db, None, None


def _not_a_view(t):
    """``t``'s memory as a tensor that is no view.  An output of a custom
    Function that is a view may not be updated in place; the kernel's
    outputs of 300 and 1500 channels are views of a buffer with the
    channel pitch padded to 16 bytes (``empty_channels_last``)."""
    if t._base is None:
        return t
    return t.new_empty(0).set_(t.untyped_storage(), t.storage_offset(), t.shape, t.stride())


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
    return to_channels_last(y)


# -- the bf16 kernel's host side: tile plan and weight layout ---------------


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class TilePlan:
    co: int  # output channels of the conv
    bn: int  # output channels per CTA tile (wgmma's N)
    bm: int  # output voxels per CTA tile
    n_tiles: int  # tiles along Co
    co8: int  # Co padded to 8: the rows of a packed weight block
    chunks: int  # 64-channel K chunks per tap
    k16_steps: int  # wgmma k16 steps run per tap
    stages: int  # ring depth

    @property
    def waste(self) -> float:
        """Share of the tensor-core columns that lie past Co."""
        return 1.0 - self.co / (self.n_tiles * self.bn)


def stage_bytes(bn: int) -> int:
    return (TILE_WIDTHS[bn] + bn) * ROW_BYTES


def smem_bytes(bn: int, stages: int) -> int:
    """Dynamic shared memory of one launch: the ring, the per-row bases,
    the barriers, and the slack to reach a 1024-byte line."""
    return stages * stage_bytes(bn) + TILE_WIDTHS[bn] * 8 + 2 * MAX_STAGES * 8 + 1024


def ring_stages(bn: int) -> int:
    """The ring's depth at tile width ``bn``: what shared memory allows."""
    return min(MAX_STAGES, (SMEM_OPTIN - smem_bytes(bn, 0)) // stage_bytes(bn))


def tile_plan(ci: int, co: int) -> TilePlan:
    """The bf16 kernel's tiling for a Ci -> Co conv.

    BN is the instantiated width that pads Co the least (the wider one on
    a tie): 60 -> 1x64, 300 -> 2x152, 1500 -> 10x152.  K walks each tap in
    64-channel chunks and runs only the k16 steps that hold real
    channels.  The ring is as deep as shared memory allows."""
    bn = min(TILE_WIDTHS, key=lambda n: (_ceil_div(co, n) * n, -n))
    return TilePlan(
        co=co, bn=bn, bm=TILE_WIDTHS[bn], n_tiles=_ceil_div(co, bn), co8=_ceil_div(co, 8) * 8,
        chunks=_ceil_div(ci, CHUNK), k16_steps=_ceil_div(ci, 16), stages=ring_stages(bn),
    )


@dataclasses.dataclass(frozen=True)
class PackedWeights:
    """Weights in a kernel's layout.  ``layout`` "wgmma" (bf16): blocks
    ``[tap][chunk][co8/8][8][64]``, each 8x64 block K-major under the
    128-byte swizzle, zero past Ci and Co.  "rows" (fp32):
    ``[tap*Ci][co8]``, zero past Co."""

    data: torch.Tensor
    shape: tuple  # the DHWIO shape packed
    layout: str


def _swizzle(t):
    """Apply the 128-byte swizzle to ``(..., 8 rows, 8 groups, 8)``: the
    16-byte group g of row r moves to g ^ r.  Its own inverse."""
    r = torch.arange(8, device=t.device)
    return t[..., r[:, None], r[:, None] ^ r[None, :], :]


def pack_weights(w, dtype) -> PackedWeights:
    """DHWIO weights (any channel slice, any strides) -> the layout the
    kernel for ``dtype`` reads.  Pure; counted in ``COUNTS['pack']``."""
    COUNTS["pack"] += 1
    kd, kh, kw, ci, co = w.shape
    taps, co8 = kd * kh * kw, _ceil_div(co, 8) * 8
    if dtype == torch.float32:
        rows = torch.zeros((taps * ci, co8), dtype=dtype, device=w.device)
        rows[:, :co] = w.reshape(taps * ci, co)
        return PackedWeights(rows, tuple(w.shape), "rows")
    if dtype != torch.bfloat16:
        raise TypeError(f"conv3d kernels take bf16 or fp32 weights, got {dtype}")
    chunks = _ceil_div(ci, CHUNK)
    t = torch.zeros((taps, chunks * CHUNK, co8), dtype=dtype, device=w.device)
    t[:, :ci, :co] = w.reshape(taps, ci, co)
    # k = chunk*64 + group*8 + e, n = block*8 + row
    t = t.reshape(taps, chunks, 8, 8, co8 // 8, 8).permute(0, 1, 4, 5, 2, 3)
    return PackedWeights(_swizzle(t).contiguous(), tuple(w.shape), "wgmma")


def unpack_weights(packed: PackedWeights):
    """The DHWIO weights a ``PackedWeights`` was made from (in its dtype)."""
    kd, kh, kw, ci, co = packed.shape
    taps = kd * kh * kw
    if packed.layout == "rows":
        return packed.data[:, :co].reshape(kd, kh, kw, ci, co)
    t = _swizzle(packed.data)  # (taps, chunks, co8/8, 8 rows, 8 groups, 8)
    t = t.permute(0, 1, 4, 5, 2, 3).reshape(taps, -1, t.shape[2] * 8)
    return t[:, :ci, :co].reshape(kd, kh, kw, ci, co)


# -- the CUDA route -----------------------------------------------------------


def empty_channels_last(shape, dtype, device):
    """An uninitialised ``(N, D, H, W, C)`` tensor whose voxels start on
    16-byte lines: for C >= 128 (what the kernel takes as input) with
    C * itemsize not a multiple of 16, a view ``[..., :C]`` of a buffer with
    C padded up.  The kernel then loads it through a tensor map (or with
    16-byte copies), which the 600- and 3000-byte voxels of the 300- and
    1500-channel levels would not allow; 8-byte copies are several times
    slower."""
    c = shape[-1]
    per16 = 16 // torch.empty((), dtype=dtype).element_size()
    if c < 128 or c % per16 == 0:
        return torch.empty(shape, dtype=dtype, device=device)
    padded = _ceil_div(c, per16) * per16
    return torch.empty((*shape[:-1], padded), dtype=dtype, device=device)[..., :c]


def to_channels_last(y):
    """``(N, C, D, H, W)`` -> ``(N, D, H, W, C)`` in the layout of
    ``empty_channels_last`` (one copy at most)."""
    y = y.permute(0, 2, 3, 4, 1)
    out = empty_channels_last(tuple(y.shape), y.dtype, y.device)
    if out.is_contiguous():
        return y.contiguous()
    out.copy_(y)
    return out


def _copy_bytes(x) -> int:
    """Widest cp.async copy (16, 8, 4 bytes) that every row start of ``x``
    is aligned to; 2 selects scalar loads (bf16 only)."""
    item = x.element_size()
    offsets = [x.data_ptr()] + [s * item for s in x.stride()[:4]]
    for av in (16, 8, 4):
        if all(o % av == 0 for o in offsets):
            return av
    return 2


def conv3d_cuda(x, w, b=None, *, relu: bool = False, packed=None):
    """Launch ``csrc/conv3d.cu`` on ``x``'s device and current stream.

    ``x`` may be a strided view (a centre crop) as long as its channel
    stride is 1.  ``packed`` is ``pack_weights(w, x.dtype)`` on ``x``'s
    device; without it the weights are packed here, on every call.  The
    bf16 kernel is told what the tensors allow: the tile width and ring
    of ``tile_plan``; activations through an im2col tensor map where every
    voxel starts on a 16-byte line (and the window is at most 16 a side),
    else gathered with cp.async; stores of 16 bytes staged through shared
    memory, of bf16 pairs or of single values, the widest the output's
    voxel pitch allows.  The output is laid out by ``empty_channels_last``.
    Raises on anything the kernel does not take, and where autograd would
    need a gradient of it (grad enabled and an input that requires grad):
    ``conv3d`` routes such calls through ``Conv3dFunction``."""
    if not x.is_cuda:
        raise ValueError("conv3d_cuda needs a CUDA tensor")
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (x, w, b)):
        raise RuntimeError(
            "conv3d_cuda gives no gradient; call conv3d (Conv3dFunction) "
            "where an input requires grad, or disable grad"
        )
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"conv3d kernel takes bf16 or fp32, got {x.dtype}")
    if x.dim() != 5 or w.dim() != 5:
        raise ValueError(f"expected NDHWC x and DHWIO w, got {x.shape}, {w.shape}")
    if not conv3d_supported(tuple(x.shape), tuple(w.shape)):
        raise ValueError(f"conv3d kernel does not take {tuple(x.shape)} x {tuple(w.shape)}")
    if x.stride(-1) != 1:
        raise ValueError("conv3d kernel needs channel stride 1 (channels-last)")
    if w.device != x.device or (b is not None and b.device != x.device):
        raise ValueError("x, w and b must be on one device")
    fp32 = x.dtype == torch.float32
    if packed is None:
        packed = pack_weights(w, x.dtype)
    if (
        packed.shape != tuple(w.shape)
        or packed.data.dtype != x.dtype
        or packed.data.device != x.device
        or packed.layout != ("rows" if fp32 else "wgmma")
    ):
        raise ValueError("packed weights do not belong to this conv")
    kd, kh, kw, ci, co = w.shape
    n, d, h, ww, _ = x.shape
    bias = None if b is None else b.to(torch.float32).contiguous()
    out = empty_channels_last(
        (n, d - kd + 1, h - kh + 1, ww - kw + 1, co), x.dtype, x.device
    )
    ldo = out.stride(3)
    av = _copy_bytes(x)
    if av == 2 and fp32:
        raise ValueError("fp32 input must be 4-byte aligned")
    lib = _lib(x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        head = (
            x.data_ptr(), packed.data.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
        )
        geom = (n, d, h, ww, ci, *x.stride()[:4], kd, kh, kw, co)
        if fp32:
            err = lib.bs_conv3d_f32(
                *head, av, *geom, packed.data.shape[1], ldo, int(relu), stream
            )
        else:
            store = 2 if ldo % 8 == 0 else 1 if ldo % 2 == 0 else 0
            tma = int(av == 16 and max(kd, kh, kw) <= 16)
            plan = tile_plan(ci, co)
            err = lib.bs_conv3d_bf16(
                *head, *geom, plan.co8, ldo, int(relu), av, plan.bn, plan.stages,
                store, tma, stream,
            )
    if err != 0:
        raise RuntimeError(f"conv3d kernel launch failed: cudaError {err}")
    key = (tuple(x.shape), tuple(w.shape))
    with _LOCK:
        COUNTS["kernel"] += 1
        KERNEL_LAUNCHES[key] = KERNEL_LAUNCHES.get(key, 0) + 1
    return out


_INITIALISED: set = set()


def _lib(device=None):
    """The built library; on first use per device, the wgmma kernels are
    given the device's opt-in shared memory (once, not per launch)."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    geom = [ll, i, i, i, i, ll, ll, ll, ll, i, i, i, i]
    lib = _build.load(
        "conv3d",
        {
            "bs_conv3d_bf16": ([p, p, p, p, *geom, i, ll, i, i, i, i, i, i, p], i),
            "bs_conv3d_f32": ([p, p, p, p, i, *geom, i, ll, i, p], i),
            "bs_conv3d_init": ([], i),
            "bs_conv3d_kernel_info": ([i, ctypes.POINTER(i)], i),
            "bs_conv3d_bf16_smem_bytes": ([i, i], i),
        },
    )
    index = torch.device("cuda" if device is None else device).index
    if index is None:
        index = torch.cuda.current_device()
    with _LOCK:
        if index not in _INITIALISED:
            with torch.cuda.device(index):
                err = lib.bs_conv3d_init()
            if err != 0:
                raise RuntimeError(f"conv3d kernel set-up failed: cudaError {err}")
            _INITIALISED.add(index)
    return lib


def kernel_info() -> list:
    """Per kernel instantiation of ``csrc/conv3d.cu``: dtype, tile,
    registers per thread, shared memory and local (spill) bytes, from
    ``cudaFuncGetAttributes``; for bf16 also the planned ring."""
    lib = _lib()
    rows = []
    info = (ctypes.c_int * 8)()
    index = 0
    while True:
        err = lib.bs_conv3d_kernel_info(index, info)
        if err == -1:
            return rows
        if err != 0:
            raise RuntimeError(f"cudaFuncGetAttributes failed: cudaError {err}")
        dtype, bn, bm, av, regs, static, max_dynamic, local = info
        row = {
            "dtype": "bf16" if dtype == 0 else "fp32", "bn": bn, "bm": bm,
            "registers": regs, "static_smem": static, "max_dynamic_smem": max_dynamic,
            "local_bytes": local,
        }
        if dtype == 0:
            row["stages"] = ring_stages(bn)
            row["dynamic_smem"] = lib.bs_conv3d_bf16_smem_bytes(bn, row["stages"])
            if row["dynamic_smem"] != smem_bytes(bn, row["stages"]):
                raise RuntimeError("host and kernel disagree on shared memory")
        else:
            row["copy_bytes"] = av
        rows.append(row)
        index += 1
