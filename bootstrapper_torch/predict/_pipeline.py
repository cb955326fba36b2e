"""Predictor machinery: a host reader thread, a one-deep dispatch/drain
loop and ROI-clipped tile writes (the JAX package's
``predict/_pipeline.py``).

``run_pipelined`` keeps one item in flight: item i+1 is dispatched before
item i is drained, so the device computes i+1 while the host waits for
i's outputs and writes them.  ``DeviceIO`` supplies the CUDA side of it:
pinned host buffers for both copies and one side stream, so a dispatch
returns as soon as its work is queued.  A ``Lane`` is one logical device
of a predictor: its model (the caller's on one device, a replica of its
own on each of several) and, on CUDA, its ``DeviceIO``.
"""

from __future__ import annotations

import contextlib
import queue
import threading
from typing import Callable, Dict, Iterable, Optional, Sequence

import numpy as np
import torch

from ..core.arrays import Array
from ..core.geometry import Coordinate, Roi
from ..models.model import head_dims
from ..utils.profiling import span


def normalize_raw(raw: np.ndarray) -> np.ndarray:
    """uint8/uint16 -> float32 in [0,1]; float passes through as float32."""
    if raw.dtype == np.uint8:
        return raw.astype(np.float32) / 255.0
    if raw.dtype == np.uint16:
        return raw.astype(np.float32) / 65535.0
    if np.issubdtype(raw.dtype, np.floating):
        return raw.astype(np.float32)
    raise ValueError(f"unsupported raw dtype {raw.dtype}")


def read_inputs(inputs: Sequence[Array], roi: Roi, is_image: bool, read=None) -> np.ndarray:
    """The channels-last concat of all inputs over ``roi``.  ``read(arr,
    roi)`` reads one input (default: reflect-padded outside the volume).

    When every input is stored uint8, it stays raw bytes (4x less
    host->device traffic than float32) and the predictor normalises on the
    device with the same float32 arithmetic."""
    device_norm = all(a.dtype == np.uint8 for a in inputs)
    chans = []
    for arr in inputs:
        x = arr.to_ndarray(roi, pad_mode="reflect") if read is None else read(arr, roi)
        if not device_norm:
            x = normalize_raw(x)
        x = x[..., None] if x.ndim == 3 else np.moveaxis(x, 0, -1)
        chans.append(x)
    x = np.concatenate(chans, axis=-1)
    if is_image and not device_norm:
        x = x * 2.0 - 1.0
    return np.ascontiguousarray(x)


def make_tile_reader(inputs: Sequence[Array], context, is_image: bool):
    """Per-tile host reader: ``read_inputs`` over the context-grown ROI."""

    def read_tile(write_roi: Roi) -> np.ndarray:
        return read_inputs(inputs, write_roi.grow(context, context), is_image)

    return read_tile


def run_pipelined(
    items: Iterable,
    read: Callable,
    dispatch: Callable,
    drain: Callable,
) -> None:
    """Reader thread + one-deep dispatch pipeline.

    ``read(item)`` runs on a reader thread (exceptions re-raise here).
    ``dispatch(host_array)`` queues the device work and returns a handle;
    ``drain(item, handle)`` runs one step behind it, and once more for the
    final item.  Spans (``utils/profiling.py:span``): ``bs.predict.read``
    on the reader thread; ``bs.predict.read_wait``, ``bs.predict.dispatch``
    and ``bs.predict.drain`` on the calling thread, which a profiler
    started there records."""
    q: queue.Queue = queue.Queue(maxsize=2)
    stop = threading.Event()

    def put(obj) -> bool:
        while not stop.is_set():
            try:
                q.put(obj, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def reader():
        try:
            for it in items:
                with span("bs.predict.read"):
                    host_arr = read(it)
                if not put((it, host_arr)):
                    return
            put(None)
        except Exception as e:  # re-raised by the consumer loop
            put(e)

    thread = threading.Thread(target=reader, daemon=True)
    thread.start()
    pending = None
    try:
        while True:
            with span("bs.predict.read_wait"):
                got = q.get()
            if got is None:
                break
            if isinstance(got, Exception):
                raise got
            item, host_arr = got
            with span("bs.predict.dispatch"):
                handle = dispatch(host_arr)
            if pending is not None:
                with span("bs.predict.drain"):
                    drain(*pending)
            pending = (item, handle)
        if pending is not None:
            with span("bs.predict.drain"):
                drain(*pending)
    finally:
        stop.set()
        thread.join()


class PinnedBuffers:
    """Host staging buffers, one per (name, shape, dtype), made at first
    use and kept: a stream's warm and steady steps differ in z, and each
    keeps its own buffers instead of pinning new ones at every change."""

    def __init__(self, pin: bool = True):
        self.pin = pin
        self._bufs: dict = {}

    def get(self, name, shape, dtype) -> torch.Tensor:
        key = (name, tuple(shape), dtype)
        buf = self._bufs.get(key)
        if buf is None:
            buf = torch.empty(tuple(shape), dtype=dtype, pin_memory=self.pin)
            self._bufs[key] = buf
        return buf


class DeviceIO:
    """Pinned staging buffers and a side stream for one device.

    Two slots alternate; under the one-deep pipeline slot ``i % 2`` is free
    again when item ``i + 2`` is dispatched, because item ``i`` has been
    drained by then (its event waited for).  ``fn`` runs on the side
    stream, so state it carries from one item to the next (a z stream's
    caches) is made and used on that stream only."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self._slots = [PinnedBuffers(), PinnedBuffers()]
        self._slot = self._slots[1]

    def upload(self, host_arr: np.ndarray) -> torch.Tensor:
        """Take the next slot and queue ``host_arr``'s copy to the device on
        the side stream, ordered after work queued on the caller's stream
        (the weights' upload and cast when the model was moved there)."""
        self._slot = self._slots[0] if self._slot is self._slots[1] else self._slots[1]
        src = torch.from_numpy(host_arr)
        staged = self._slot.get("in", src.shape, src.dtype)
        staged.copy_(src)
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self.stream):
            return staged.to(self.device, non_blocking=True)

    def download(self, outs: Dict[str, torch.Tensor]):
        """Queue the copies of a dict of device outputs into the current
        slot's pinned buffers on the side stream.  Returns ``(event,
        outputs)``: the pinned outputs are valid once the event has
        completed."""
        with torch.cuda.stream(self.stream):
            host = {}
            for k, v in outs.items():
                host[k] = self._slot.get(k, v.shape, v.dtype)
                host[k].copy_(v, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self.stream)
        return event, host

    def run(self, host_arr: np.ndarray, fn: Callable):
        """Upload ``host_arr``, run ``fn`` on the side stream, queue the
        downloads of its dict of outputs (``download``)."""
        x = self.upload(host_arr)
        with torch.cuda.stream(self.stream):
            outs = fn(x)
        return self.download(outs)


class Lane:
    """One logical device of a multi-device predictor: its own replica of
    the model (``Model.replicate``) and, on a CUDA device, its own
    ``DeviceIO``.  A device list may name one device more than once; each
    entry is a lane of its own, and what moves between lanes is copied,
    also between two lanes of one card."""

    def __init__(self, model, device: torch.device, compute_dtype, replicate: bool = True):
        self.device = device
        if replicate:
            model = model.replicate(device, compute_dtype)
        else:
            model = model.to_compute(device, compute_dtype)
        self.model = model.eval()
        self.io = DeviceIO(device) if device.type == "cuda" else None

    @classmethod
    def adopt(cls, model, device: torch.device, compute_dtype) -> "Lane":
        """The lane of a one-device predictor: ``model`` itself, moved to
        ``device`` and cast, with no copy of its weights."""
        return cls(model, device, compute_dtype, replicate=False)

    def on_stream(self):
        """The lane's side stream as the current one (nothing on the CPU)."""
        return contextlib.nullcontext() if self.io is None else torch.cuda.stream(self.io.stream)

    def upload(self, host_arr: np.ndarray) -> torch.Tensor:
        if self.io is None:
            return torch.from_numpy(np.ascontiguousarray(host_arr))
        return self.io.upload(host_arr)

    def receive(self, t: torch.Tensor, src: "Lane") -> torch.Tensor:
        """A copy of ``t`` (made on lane ``src``) on this lane's device, made
        on this lane's stream after ``src``'s queued work."""
        if self.io is None:
            return t.clone()
        if src.io is not None:
            self.io.stream.wait_stream(src.io.stream)
        with self.on_stream():
            out = torch.empty_like(t, device=self.device)
            out.copy_(t, non_blocking=True)
        if t.is_cuda:
            t.record_stream(self.io.stream)  # read here: not to be reused before
        return out

    def download(self, outs: Dict[str, torch.Tensor]):
        """``(event or None, outputs)``; ``fetch`` reads it."""
        if self.io is None:
            return None, outs
        return self.io.download(outs)

    def run(self, host_arr: np.ndarray, fn: Callable):
        """Upload ``host_arr``, run ``fn`` on it on the lane's stream and
        queue the download of its outputs; ``fetch`` reads the handle."""
        x = self.upload(host_arr)
        with self.on_stream():
            outs = fn(x)
        return self.download(outs)


def fetch(handle) -> Dict[str, np.ndarray]:
    """Wait for a ``Lane.download`` (or a ``DeviceIO.run``) and return its
    outputs as numpy arrays; the wait is the span
    ``bs.predict.device_wait``."""
    event, outs = handle
    with span("bs.predict.device_wait"):
        if event is not None:
            event.synchronize()
    return {k: v.numpy() for k, v in outs.items()}


def launches_now() -> int:
    """The conv kernels' CUDA launches so far (K1's ``ops.conv3d.COUNTS``
    and, under ``BS_INT8=1``, K4's ``ops.quant.COUNTS``): a multi-device
    predictor reads it around each lane's forward, all queued from one
    thread, to count the launches of each logical device."""
    from ..ops import conv3d, quant

    return conv3d.COUNTS["kernel"] + quant.COUNTS["kernel"]


def dispatch_lanes(lanes: Sequence["Lane"], arrs: Sequence[np.ndarray], fns: Sequence[Callable],
                   launches: list) -> list:
    """Queue ``lanes[k].run(arrs[k], fns[k])`` on every lane and return the
    handles, adding each lane's conv kernel launches to ``launches[k]``.

    Without int8, or on one lane, the lanes are queued one after another
    from this thread.  Under ``BS_INT8=1`` over several lanes each lane
    runs in a thread of its own as a lane of one ``quant.ScaleGroup``
    (the lanes take turns, from one quantization point to the next), so
    that every conv-pass input is quantized with one scale over all lanes,
    as the JAX package's graph over a sharded batch takes it; the threads
    are joined once every lane's work is queued (nothing waits for the
    devices).  A lane that fails releases the others and its error is
    raised here."""
    from ..ops import quant

    if len(lanes) == 1 or not quant.int8_enabled():
        handles = []
        for k, (lane, arr, fn) in enumerate(zip(lanes, arrs, fns)):
            n0 = launches_now()
            handles.append(lane.run(arr, fn))
            launches[k] += launches_now() - n0
        return handles
    group = quant.ScaleGroup(len(lanes))
    handles: list = [None] * len(lanes)
    errors: list = []

    def run(k):
        try:
            with group.lane(k):
                handles[k] = lanes[k].run(arrs[k], fns[k])
        except BaseException as e:  # re-raised below, after every lane has stopped
            errors.append(e)

    threads = [threading.Thread(target=run, args=(k,), daemon=True) for k in range(len(lanes))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise next((e for e in errors if not isinstance(e, quant.LaneFailed)), errors[0])
    for k, n in enumerate(group.launches):
        launches[k] += n
    return handles


class TileWriter:
    """ROI-clipped writes of per-tile model outputs.

    ``outputs`` maps head name -> destination Array; ``outputs_cfg`` is the
    model's ``net_config["outputs"]`` (for the per-head channel count).
    ``clip_roi`` clips every write further, for tiles that overhang the
    requested ROI on purpose (a z stream's last step)."""

    def __init__(
        self,
        outputs: Dict[str, Array],
        outputs_cfg: Dict[str, dict],
        voxel_size: Coordinate,
        clip_roi: Optional[Roi] = None,
    ):
        self.outputs = outputs
        self.dims = {k: head_dims(cfg) for k, cfg in outputs_cfg.items()}
        self.voxel_size = voxel_size
        self.clip_roi = clip_roi

    def drain_batch(
        self, batch_tiles: Sequence[Roi], outs: Dict, clips: Optional[Sequence[Roi]] = None
    ) -> None:
        """Write every tile of one batch of host outputs
        (``outs[name]``: (B, D, H, W, C)); ``clips[j]``, where given,
        clips tile j's writes too.  The span ``bs.predict.write``."""
        with span("bs.predict.write"):
            for j, wroi in enumerate(batch_tiles):
                for name, arr in self.outputs.items():
                    pred = np.moveaxis(np.asarray(outs[name][j]), -1, 0)
                    dest = wroi.intersect(arr.roi)
                    if self.clip_roi is not None:
                        dest = dest.intersect(self.clip_roi)
                    if clips is not None:
                        dest = dest.intersect(clips[j])
                    if dest.empty:
                        continue
                    sl = tuple(
                        slice(int(a), int(a + s))
                        for a, s in zip(
                            (dest.begin - wroi.begin) / self.voxel_size,
                            Coordinate(dest.shape) / self.voxel_size,
                        )
                    )
                    arr[dest] = pred[(slice(None),) + sl][: self.dims[name]]
