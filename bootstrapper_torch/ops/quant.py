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
  a channel concat on its own, a residual's input before its centre crop).
- Weights: one scale per output channel, the max over every other axis,
  over 127, from the fp32 parameters (``models/unet.py:Conv`` packs them
  before a predictor casts the model).
- ``q = clip(round(v / s), -127, 127)``: division (not a reciprocal
  product), ties to even.
- int32 accumulation; ``acc * (sx * sw)`` in fp32, then the bias and the
  ReLU, cast to the compute dtype once.  (The JAX package casts before it
  adds the bias; in fp32 that is the same, in bf16 one rounding apart.)

Two steps, so that one quantized activation can feed several convs:
``quantize_input`` makes a ``QuantizedInput`` (the s8 tensor and its
scale), ``qconv_quantized`` convolves one, or a centre crop of one
(``QuantizedInput.cropped``): ``quantize(crop(x), amax(x))`` equals
``crop(quantize(x, amax(x)))`` bit for bit, so a conv pass's 1x1 residual
reads its first conv's s8 input.  ``qconv`` is the two in one call.

Routing, decided by the tensor's device before any launch: a CUDA tensor
runs the hand-written kernels of ``csrc/qconv3d.cu`` (K4: the activation's
amax and its quantization into s8 channels padded to a pitch of 16, then a
``wgmma`` s8 implicit-GEMM conv fed by TMA with the rescale fused); a CPU
(or ``meta``) tensor the plain versions: ``quantize``, and ``F.conv3d`` in
float64 on the integer-valued tensors, which is exact (every partial sum
stays below 2^53), then the same rescale.

Over a batch spread across devices (``predict --sharded``) the lanes of a
``ScaleGroup`` share each scale: every lane's amax pass, then the maximum
of all lanes' amaxes on each lane, then each lane's quantization with it,
so that each conv-pass input has one scale over the whole batch, as the
JAX package's graph over the sharded batch takes it.

``COUNTS["kernel"]`` counts conv launches, ``COUNTS["quantize"]`` pairs of
quantization passes (amax, quantize); ``KERNEL_LAUNCHES`` splits the conv
launches by shape.  Gradients of round and clip are zero, so the U-Net
takes this route only with grad disabled and training ignores the flag.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import os
import threading

import torch
import torch.nn.functional as F

from . import _build
from .conv3d import empty_channels_last

#: route counters: "kernel" (conv kernel launches), "quantize" (pairs of
#: quantization kernel launches), "plain" (CPU convs), "quantize_plain" (CPU
#: quantizations), "pack" (weights quantized and packed)
COUNTS = {"kernel": 0, "quantize": 0, "plain": 0, "quantize_plain": 0, "pack": 0}

#: conv kernel launches by conv: (x shape, w shape) -> count
KERNEL_LAUNCHES: dict = {}

_LOCK = threading.Lock()

CHUNK = 128  # channels per K chunk: one 128-byte swizzled row of s8
ROW_BYTES = 128
PITCH = 16  # the s8 activations' channel pitch is a multiple of it
#: the conv kernel's tile widths BN -> rows BM of the CTA tile (two
#: consumer warpgroups of BM/2 rows each); as in csrc/qconv3d.cu
TILE_WIDTHS = {16: 256, 64: 128, 160: 256, 256: 128}
MAX_STAGES = 6
SMEM_OPTIN = 232448  # bytes of shared memory one block can opt in to (H100)
SMEM_HALF = 233472 // 2 - 1024  # each of two blocks on one SM (228 KB, 1 KB reserved a block)


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


def channel_pitch(ci: int) -> int:
    """The s8 activations' channel pitch for ``ci`` channels: ``ci`` rounded
    up to 16, so that every voxel starts on a 16-byte line (the conv's
    tensor map and 16-byte copies need it)."""
    return -(-ci // PITCH) * PITCH


def k_pitch(ci: int) -> int:
    """Bytes of K each tap takes in the conv's K walk: up to a pitch of 64,
    the pitch rounded up to 16, 32 or 64, so that 8, 4 or 2 taps share a
    128-byte K row (gathered); above, whole 128-channel chunks a tap
    (through the tensor map)."""
    cp = channel_pitch(ci)
    if cp <= 64:
        return next(p for p in (16, 32, 64) if p >= cp)
    return _ceil_div(ci, CHUNK) * CHUNK


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _swizzle(t):
    """Apply the 128-byte swizzle to ``(..., 8 rows, 8 groups, 16)``: the
    16-byte group g of row r moves to g ^ r.  Its own inverse."""
    r = torch.arange(8, device=t.device)
    return t[..., r[:, None], r[:, None] ^ r[None, :], :]


@dataclasses.dataclass(frozen=True)
class QuantizedWeights:
    """One conv's int8 weights: ``wq`` DHWIO int8, ``sw`` (Co,) fp32, and
    ``data``, the kernel's layout: K is ``k = tap * kp + c`` (``kp``:
    ``k_pitch(Ci)``; a tap's 128-channel chunks, or several taps to a
    128-byte row for narrow Ci), padded to 128, and each 128-byte K chunk a
    block of ``co8`` rows (Co padded to 8) of 128 s8, K-major under the
    128-byte swizzle, zero past Ci and Co; ``cp`` the activations' channel
    pitch."""

    wq: torch.Tensor
    sw: torch.Tensor
    data: torch.Tensor
    cp: int
    kp: int

    @property
    def shape(self) -> tuple:
        return tuple(self.wq.shape)

    def to(self, device) -> "QuantizedWeights":
        return dataclasses.replace(self, wq=self.wq.to(device), sw=self.sw.to(device), data=self.data.to(device))


def pack_qweights(w) -> QuantizedWeights:
    """Quantize DHWIO weights (any channel slice, any strides) and pack
    them for the kernel; counted in ``COUNTS['pack']``.  ``w`` is to be the
    fp32 parameter, as the JAX package quantizes it."""
    COUNTS["pack"] += 1
    wq, sw = quantize_weights(w)
    kd, kh, kw, ci, co = wq.shape
    taps, co8, kp = kd * kh * kw, _ceil_div(co, 8) * 8, k_pitch(ci)
    chunks = _ceil_div(taps * kp, CHUNK)
    t = torch.zeros((chunks * CHUNK, co8), dtype=torch.int8, device=wq.device)
    t[: taps * kp].view(taps, kp, co8)[:, :ci, :co] = wq.reshape(taps, ci, co)
    # k = chunk*128 + group*16 + e, n = block*8 + row
    t = t.reshape(chunks, 8, 16, co8 // 8, 8).permute(0, 3, 4, 1, 2)
    return QuantizedWeights(wq, sw, _swizzle(t).contiguous(), channel_pitch(ci), kp)


def unpack_qweights(qw: QuantizedWeights) -> torch.Tensor:
    """The DHWIO int8 weights that ``qw.data`` holds."""
    kd, kh, kw, ci, co = qw.shape
    taps = kd * kh * kw
    t = _swizzle(qw.data)  # (chunks, co8/8, 8 rows, 8 groups, 16)
    t = t.permute(0, 3, 4, 1, 2).reshape(-1, t.shape[1] * 8)
    return t[: taps * qw.kp].reshape(taps, qw.kp, -1)[:, :ci, :co].reshape(kd, kh, kw, ci, co)


@dataclasses.dataclass(frozen=True)
class QuantizedInput:
    """An activation quantized once: ``xq`` int8 ``(N, D, H, W, Ci)`` and its
    fp32 scale ``sx``; ``dtype`` is the activation's (the convs' default
    output dtype).  On the card ``xq`` is a view of a buffer whose channel
    pitch is ``channel_pitch(Ci)``, zero past Ci."""

    xq: torch.Tensor
    sx: torch.Tensor
    dtype: torch.dtype

    @property
    def shape(self) -> tuple:
        return tuple(self.xq.shape)

    def cropped(self, target_spatial) -> "QuantizedInput":
        """The centre crop of the spatial dims to ``target_spatial`` (a view,
        the same scale): what a 1x1 residual reads."""
        offsets = [(s - t) // 2 for s, t in zip(self.xq.shape[1:4], target_spatial)]
        sl = tuple(slice(o, o + t) for o, t in zip(offsets, target_spatial))
        return dataclasses.replace(self, xq=self.xq[(slice(None), *sl)])


#: the calling thread's lane of a ``ScaleGroup`` (``ScaleGroup.lane``)
_SHARED = threading.local()

#: the switch of the scale recorder (``record_scales``): a list while on, to
#: which every ``ScaleGroup`` made meanwhile appends itself; None (off) on
#: the main path
SCALE_RECORD = None


class LaneFailed(RuntimeError):
    """Raised in a lane of a ``ScaleGroup`` whose another lane failed."""


class ScaleGroup:
    """Lanes (logical devices) whose forwards share each int8 activation
    scale, as the JAX package's graph over a batch sharded across devices
    takes one scale per conv-pass input over the whole batch.

    Each lane runs its forward in a thread of its own inside ``lane(k)``,
    and the lanes take turns: one baton passes round them, so that only one
    thread runs at a time (two threads queueing small operations at once
    hand the interpreter's lock back and forth at every one of them, which
    tripled the host's time on an H100).  At every quantization point
    (``quantize_input``) a lane queues its amax pass, leaves the amax in a
    slot and passes the baton on; when the baton comes back, every lane has
    left its amax there, and the lane takes their maximum (a max never
    rounds) and quantizes with it.  The amaxes stay on the devices: lane
    k's stream waits for an event recorded after lane j's amax pass and
    copies its one value, as ``predict._pipeline.Lane.receive`` orders a
    copy; no host synchronisation.  Two slots alternate: a lane writes a
    point's slot again only after every lane has read it.  On the CPU the
    same path runs the plain amax and ``quantize``.

    ``launches[k]``: lane k's conv kernel launches (``qconv_cuda``),
    ``plain[k]`` its plain convs; ``recorded[k]`` (while ``record_scales``
    is on): per point, lane k's own amax and the scale it quantized with."""

    def __init__(self, lanes: int):
        self.lanes = lanes
        self._turns = [threading.Semaphore(0) for _ in range(lanes)]
        self._failed = False
        self._slots = ([None] * lanes, [None] * lanes)
        self._points = [0] * lanes
        self.launches = [0] * lanes
        self.plain = [0] * lanes
        self.recorded = None
        if SCALE_RECORD is not None:
            self.recorded = [[] for _ in range(lanes)]
            SCALE_RECORD.append(self)

    @contextlib.contextmanager
    def lane(self, k: int):
        """The calling thread as lane ``k`` until the block ends: lane 0
        starts with the baton, lane k after lane k - 1 has passed its first
        point; a lane that ends (or fails) passes the baton on."""
        prev = getattr(_SHARED, "lane", None)
        _SHARED.lane = (self, k)
        try:
            if k:
                self._wait(k)
            yield self
        except BaseException:
            self.fail()
            raise
        finally:
            _SHARED.lane = prev
            self._turns[(k + 1) % self.lanes].release()

    def fail(self) -> None:
        """Wake every lane; each raises ``LaneFailed`` where it waits."""
        self._failed = True
        for turn in self._turns:
            turn.release()

    def _wait(self, k: int) -> None:
        self._turns[k].acquire()
        if self._failed:
            raise LaneFailed("another lane of this scale group failed")

    def quantize(self, k: int, x) -> QuantizedInput:
        cuda = x.is_cuda
        local = amax_cuda(x) if cuda else x.abs().amax().float()
        event = None
        if cuda:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(x.device))
        slot = self._slots[self._points[k] % 2]
        self._points[k] += 1
        slot[k] = (local, event)
        self._turns[(k + 1) % self.lanes].release()
        self._wait(k)
        amax = self._max_of(k, slot, x.device)
        if cuda:
            q = quantize_pass_cuda(x, amax)
            with _LOCK:
                COUNTS["quantize"] += 1
        else:
            q = QuantizedInput(*quantize(x, _over_127(torch.clamp(amax, min=1e-30))), x.dtype)
            with _LOCK:
                COUNTS["quantize_plain"] += 1
        if self.recorded is not None:
            self.recorded[k].append((local, q.sx))
        return q

    def _max_of(self, k: int, slot: list, device) -> torch.Tensor:
        """The maximum of the slot's amaxes on lane ``k``'s device and stream
        (int32 bits of non-negative floats on the card, whose order is the
        floats' order; fp32 on the CPU)."""
        out = slot[k][0]
        stream = torch.cuda.current_stream(device) if out.is_cuda else None
        for j, (t, event) in enumerate(slot):
            if j == k:
                continue
            if stream is not None:
                stream.wait_event(event)
                c = torch.empty_like(t, device=device)
                c.copy_(t, non_blocking=True)
                t.record_stream(stream)  # read here: not to be reused before
                t = c
            out = torch.maximum(out, t)
        return out

    def scales(self) -> list:
        """Per quantization point, ``(lane amaxes, lane scales)`` as fp32
        host values (recorded groups only)."""
        def f32(t):
            t = t.detach().cpu()
            return float(t.view(torch.float32) if t.dtype == torch.int32 else t.float())

        points = len(self.recorded[0])
        if any(len(r) != points for r in self.recorded):
            raise RuntimeError("the lanes passed different numbers of quantization points")
        return [
            ([f32(r[p][0]) for r in self.recorded], [f32(r[p][1]) for r in self.recorded])
            for p in range(points)
        ]


@contextlib.contextmanager
def record_scales():
    """Switch the scale recorder on for a block: every ``ScaleGroup`` made
    inside it records each lane's amax and scale at every quantization
    point; ``as`` gives the list of those groups."""
    global SCALE_RECORD
    prev, SCALE_RECORD = SCALE_RECORD, []
    try:
        yield SCALE_RECORD
    finally:
        SCALE_RECORD = prev


def shared_scale(amaxes) -> float:
    """The scale that every lane must quantize with, from the lanes' own
    amaxes, as the plain version computes it: ``max(max(amaxes), 1e-30) /
    127`` in fp32."""
    amax = torch.tensor(amaxes, dtype=torch.float32).amax()
    return float(_over_127(torch.clamp(amax, min=1e-30)))


def quantize_input(x) -> QuantizedInput:
    """``x`` (NDHWC) quantized with its own scale, or, in a lane of a
    ``ScaleGroup``, with the group's (``ScaleGroup.quantize``): the two
    kernels on a CUDA tensor (``COUNTS['quantize']``), ``quantize``
    elsewhere (``COUNTS['quantize_plain']``)."""
    share = getattr(_SHARED, "lane", None)
    if share is not None:
        return share[0].quantize(share[1], x)
    if x.is_cuda:
        q = quantize_cuda(x)
        with _LOCK:
            COUNTS["quantize"] += 1
        return q
    COUNTS["quantize_plain"] += 1
    return QuantizedInput(*quantize(x), x.dtype)


def qconv(x, w, b=None, *, relu: bool = False, out_dtype=None, qw=None):
    """``conv_valid(x, w) (+ b) (ReLU)`` in int8, as the JAX package's
    ``qconv``: NDHWC ``x``, DHWIO ``w``, output in ``out_dtype`` (default
    ``x``'s).  ``qw`` is ``pack_qweights(w)`` as the caller keeps it (made
    here without it).  ``quantize_input``, then ``qconv_quantized``."""
    if qw is None:
        qw = pack_qweights(w)
    return qconv_quantized(quantize_input(x), qw, b, relu=relu, out_dtype=out_dtype)


def qconv_quantized(q: QuantizedInput, qw: QuantizedWeights, b=None, *, relu: bool = False,
                    out_dtype=None):
    """The conv of an already quantized input (or a crop of one): the
    kernel on a CUDA tensor, the plain version elsewhere."""
    out_dtype = q.dtype if out_dtype is None else out_dtype
    if q.xq.is_cuda:
        return qconv_cuda(q, qw, b, relu=relu, out_dtype=out_dtype)
    share = getattr(_SHARED, "lane", None)
    with _LOCK:
        COUNTS["plain"] += 1
        if share is not None:
            share[0].plain[share[1]] += 1
    return _qconv_int(q.xq, q.sx, qw.wq, qw.sw, b, relu, out_dtype)


def _qconv_int(xq, sx, wq, sw, b, relu, out_dtype):
    acc = F.conv3d(
        xq.to(torch.float64).permute(0, 4, 1, 2, 3),
        wq.to(device=xq.device, dtype=torch.float64).permute(4, 3, 0, 1, 2),
    ).permute(0, 2, 3, 4, 1)
    y = acc.to(torch.float32) * (sx * sw.to(xq.device))
    if b is not None:
        y = y + b.to(device=xq.device, dtype=torch.float32)
    if relu:
        y = y.clamp_(min=0)
    return y.to(out_dtype)


def qconv_plain(x, w, b=None, *, relu: bool = False, out_dtype=torch.bfloat16, qw=None, sx=None):
    """The kernels' arithmetic in plain PyTorch: ``quantize`` (with ``sx``
    if given), the s8 products summed exactly by ``F.conv3d`` in float64,
    then ``acc * (sx * sw)`` in fp32, the bias, the ReLU, one cast."""
    xq, sx = quantize(x, sx)
    wq, sw = quantize_weights(w) if qw is None else (qw.wq, qw.sw)
    return _qconv_int(xq, sx, wq, sw, b, relu, out_dtype)


# -- the CUDA route -----------------------------------------------------------


def _load_bytes(x) -> int:
    """Widest load (16 or 8 bytes) that ``x``'s start and voxel strides
    allow, else the element's size."""
    item = x.element_size()
    offsets = [x.data_ptr()] + [s * item for s in x.stride()[:4]]
    for vb in (16, 8):
        if all(o % vb == 0 for o in offsets):
            return vb
    return item


def _check_activation(t, what):
    if t.dim() != 5 or t.stride(-1) != 1:
        raise ValueError(f"qconv kernels need NDHWC {what} with channel stride 1, got {tuple(t.shape)}")
    if t.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"qconv kernels take bf16 or fp32 activations, got {t.dtype}")


def amax_cuda(x) -> torch.Tensor:
    """The amax pass alone: an int32 scalar on ``x``'s device holding the
    bits of ``max |x|`` (a strided NDHWC view, bf16 or fp32)."""
    _check_activation(x, "x")
    amax = torch.zeros((), dtype=torch.int32, device=x.device)
    lib = _lib(x.device)
    with torch.cuda.device(x.device):
        err = lib.bs_s8_amax(
            x.data_ptr(), int(x.dtype == torch.bfloat16), _load_bytes(x), *x.shape, *x.stride()[:4],
            amax.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"amax kernel launch failed: cudaError {err}")
    return amax


def quantize_pass_cuda(x, amax) -> QuantizedInput:
    """The quantization pass alone: ``x`` in s8 with the scale of ``amax``
    (``amax_cuda``'s result), into a contiguous buffer at the channel
    pitch, as a view of its first Ci channels."""
    _check_activation(x, "x")
    ci = x.shape[-1]
    xq = torch.empty((*x.shape[:4], channel_pitch(ci)), dtype=torch.int8, device=x.device)
    sx = torch.empty((), dtype=torch.float32, device=x.device)
    lib = _lib(x.device)
    with torch.cuda.device(x.device):
        err = lib.bs_s8_quantize(
            x.data_ptr(), int(x.dtype == torch.bfloat16), _load_bytes(x), *x.shape, *x.stride()[:4],
            xq.shape[-1], amax.data_ptr(), sx.data_ptr(), xq.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"quantize kernel launch failed: cudaError {err}")
    return QuantizedInput(xq[..., :ci], sx, x.dtype)


def quantize_cuda(x) -> QuantizedInput:
    """Both passes on ``x``'s device and current stream: the amax of ``x``,
    then ``x`` quantized with it.  No host synchronisation."""
    if not x.is_cuda:
        raise ValueError("quantize_cuda needs a CUDA tensor")
    return quantize_pass_cuda(x, amax_cuda(x))


@dataclasses.dataclass(frozen=True)
class TilePlan:
    co: int  # output channels of the conv
    bn: int  # output channels per CTA tile (wgmma's N)
    n_tiles: int  # tiles along Co
    co8: int  # Co padded to 8: the rows of a packed weight block
    stages: int  # ring depth


def stage_bytes(bn: int) -> int:
    return (TILE_WIDTHS[bn] + bn) * ROW_BYTES


def smem_bytes(bn: int, stages: int) -> int:
    """Dynamic shared memory of one launch: the ring, the per-row bases of
    the gather, the barriers, and the slack to reach a 1024-byte line."""
    return stages * stage_bytes(bn) + TILE_WIDTHS[bn] * 8 + 2 * MAX_STAGES * 8 + 1024


def blocks_per_sm(bn: int) -> int:
    """Blocks of tile width ``bn`` that share an SM: two for the narrow
    tiles (16, 64), one otherwise; as in csrc/qconv3d.cu."""
    return 2 if bn <= 64 else 1


def ring_stages(bn: int) -> int:
    """The ring's depth at tile width ``bn``: what shared memory allows
    (half an SM's where two blocks share it)."""
    cap = SMEM_OPTIN if blocks_per_sm(bn) == 1 else SMEM_HALF
    return min(MAX_STAGES, (cap - smem_bytes(bn, 0)) // stage_bytes(bn))


def tile_plan(co: int) -> TilePlan:
    """The conv kernel's tiling for a Ci -> Co conv.

    BN is 16 up to 16 channels; above, the width of 64, 160 or 256 that
    pads Co the least (the wider one on a tie): 60 -> 1x64, 300 -> 2x160,
    1500 -> 6x256.  K walks the weights' layout (``k_pitch``) and runs
    only the k32 steps that hold real channels.  The ring is as deep as
    shared memory allows."""
    widths = [16] if co <= 16 else [n for n in TILE_WIDTHS if n > 16]
    bn = min(widths, key=lambda n: (_ceil_div(co, n) * n, -n))
    return TilePlan(
        co=co, bn=bn, n_tiles=_ceil_div(co, bn), co8=_ceil_div(co, 8) * 8, stages=ring_stages(bn),
    )


def _store_mode(out, plan: TilePlan) -> int:
    """2: one contiguous run per warpgroup (one tile holds every channel of
    a dense output), 1: 16-byte lines along the channels, 0: single values."""
    ldo, es = out.stride(3), out.element_size()
    if out.data_ptr() % 16:
        return 0
    if plan.n_tiles == 1 and ldo == plan.co:
        return 2
    return 1 if (ldo * es) % 16 == 0 else 0


def qconv_cuda(q: QuantizedInput, qw: QuantizedWeights, b=None, *, relu: bool = False,
               out_dtype=torch.bfloat16):
    """Launch the conv of ``csrc/qconv3d.cu`` on ``q``'s device and current
    stream: the s8 view ``q.xq`` (a quantized tensor or a centre crop of
    one, its voxels at the pitch ``qw.cp``) through an im2col tensor map,
    with the rescale, bias and ReLU fused; bf16 or fp32 out, laid out by
    ``empty_channels_last``.  No host synchronisation.  Raises on anything
    the kernel does not take."""
    xq = q.xq
    if not xq.is_cuda:
        raise ValueError("qconv_cuda needs a CUDA tensor")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"qconv kernel writes bf16 or fp32, not {out_dtype}")
    kd, kh, kw, ci, co = qw.shape
    n, d, h, ww, cx = xq.shape
    if xq.dtype != torch.int8 or xq.stride(-1) != 1 or cx != ci or d < kd or h < kh or ww < kw:
        raise ValueError(f"qconv kernel does not take {tuple(xq.shape)} x {qw.shape}")
    if max(kd, kh, kw) > 16:
        raise ValueError(f"qconv kernel takes windows up to 16 a side, not {qw.shape[:3]}")
    strides = xq.stride()[:4]
    if xq.stride(3) != qw.cp or any(s % PITCH for s in strides) or xq.data_ptr() % 16:
        raise ValueError("the s8 input is not a view of a tensor at the weights' channel pitch")
    if qw.data.device != xq.device or (b is not None and b.device != xq.device):
        raise ValueError("the input, the packed weights and b must be on one device")
    dev = xq.device
    bias = None if b is None else b.to(torch.float32).contiguous()
    out = empty_channels_last((n, d - kd + 1, h - kh + 1, ww - kw + 1, co), out_dtype, dev)
    plan = tile_plan(co)
    tpr = CHUNK // qw.kp if qw.kp < CHUNK else 0
    lib = _lib(dev)
    with torch.cuda.device(dev):
        err = lib.bs_qconv3d(
            xq.data_ptr(), n, d, h, ww, qw.cp, ci, *strides, tpr, qw.data.data_ptr(), q.sx.data_ptr(),
            qw.sw.data_ptr(), None if bias is None else bias.data_ptr(), out.data_ptr(),
            int(out_dtype == torch.float32), kd, kh, kw, co, plan.co8, out.stride(3), int(relu),
            plan.bn, plan.stages, _store_mode(out, plan), torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"qconv kernel launch failed: cudaError {err}")
    key = (tuple(xq.shape), qw.shape)
    share = getattr(_SHARED, "lane", None)
    with _LOCK:
        COUNTS["kernel"] += 1
        KERNEL_LAUNCHES[key] = KERNEL_LAUNCHES.get(key, 0) + 1
        if share is not None:
            share[0].launches[share[1]] += 1
    return out


_INITIALISED: set = set()


def _lib(device=None):
    """The built library; on first use per device, the conv kernels are
    given the device's opt-in shared memory and the tensor-map encoder is
    found (once, not per launch)."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    view = [p, i, i, i, i, i, i, i, ll, ll, ll, ll]
    lib = _build.load(
        "qconv3d",
        {
            "bs_s8_amax": ([*view, p, p], i),
            "bs_s8_quantize": ([*view, i, p, p, p, p], i),
            "bs_qconv3d": (
                [p, ll, i, i, i, i, i, ll, ll, ll, ll, i, p, p, p, p, p, i, i, i, i, i, i, ll, i, i, i, i, p],
                i,
            ),
            "bs_qconv3d_init": ([], i),
            "bs_qconv3d_smem_bytes": ([i, i], i),
            "bs_qconv3d_kernel_info": ([i, ctypes.POINTER(i)], i),
        },
    )
    index = torch.device("cuda" if device is None else device).index
    if index is None:
        index = torch.cuda.current_device()
    with _LOCK:
        if index not in _INITIALISED:
            with torch.cuda.device(index):
                err = lib.bs_qconv3d_init()
            if err != 0:
                raise RuntimeError(f"qconv kernel set-up failed: cudaError {err}")
            _INITIALISED.add(index)
    return lib


def kernel_info() -> list:
    """Per kernel instantiation of ``csrc/qconv3d.cu``: the conv's tile
    (with its planned ring and dynamic shared memory) or the pass's input
    type and load width, registers per thread, shared memory and local
    (spill) bytes, from ``cudaFuncGetAttributes``."""
    lib = _lib()
    rows, info, index = [], (ctypes.c_int * 9)(), 0
    while True:
        err = lib.bs_qconv3d_kernel_info(index, info)
        if err == -1:
            return rows
        if err != 0:
            raise RuntimeError(f"cudaFuncGetAttributes failed: cudaError {err}")
        kind, bn, bm, bf16, vb, regs, static, max_dynamic, local = info
        row = {
            "kind": ("conv", "amax", "quantize")[kind], "registers": regs, "static_smem": static,
            "max_dynamic_smem": max_dynamic, "local_bytes": local,
        }
        if kind == 0:
            row.update(bn=bn, bm=bm, stages=ring_stages(bn))
            row["dynamic_smem"] = lib.bs_qconv3d_smem_bytes(bn, row["stages"])
            if row["dynamic_smem"] != smem_bytes(bn, row["stages"]):
                raise RuntimeError("host and kernel disagree on shared memory")
        else:
            row.update(input="bf16" if bf16 else "fp32", load_bytes=vb)
        rows.append(row)
        index += 1
