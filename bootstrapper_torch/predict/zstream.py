"""Z-streaming prediction: overlap-save inference over deep volumes (the
JAX package's ``predict/zstream.py``, one device).

The tiled predictor (``scan.Predictor``) recomputes the net's z context
for every tile: 28 slices of context for 4 output slices at the 3d_affs
tile.  This predictor walks each xy column in z order instead and keeps
per-level activation caches on the device (``models/zstream.py``): after
one warm step per column, every step turns ``s`` new input slices into
``s`` output slices with no z context recomputed.  The z step is a free
parameter (``plan_stream``), so the step graphs stay thin in z and the
memory freed pays for wider xy tiles, which cuts the xy context too.

Valid convs are exact under concatenation and the net never resamples z,
so at the same xy tile the outputs equal the tiled predictor's (bit for
bit on the card, where every conv sums a voxel alike at any shape).  A
tiled predictor with another xy tile differs within a few voxels of its
tiles' xy edges, whose outputs depend on where the edge lies (the
trilinear upsample clamps there).  xy handling (tiling, reflect pad) is
the tiled predictor's; the volume's z remainder is covered by reads
reflect-padded past the end, whose writes are clipped.
"""

from __future__ import annotations

import math
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..core.arrays import Array
from ..core.geometry import Coordinate, Roi
from ..models.model import Model
from ..models.unet import compute_output_shape
from ..models.zstream import stream_eligible
from ._pipeline import DeviceIO, TileWriter, read_inputs, run_pipelined
from .scan import DEFAULT_DEVICE_BYTES, device_memory_bytes, tile_rois

#: device memory a steady step takes per effective input voxel
#: ``(s + 8) * xy_in**2`` (bf16, full-width 3d_affs), rounded up from the
#: most that ``chip_smoke.py``'s ``zstream_step`` sweep read on an H100
STEADY_BYTES_PER_EFF_VOXEL = 650
#: share of the card's memory the steady step may plan for; the rest holds
#: the weights, the stream state and the allocator's slack
STREAM_MEMORY_SHARE = 0.6


def default_budget(device=None) -> int:
    """Effective input voxels a steady step may take on ``device``."""
    mem = device_memory_bytes(device) or DEFAULT_DEVICE_BYTES
    return int(STREAM_MEMORY_SHARE * mem / STEADY_BYTES_PER_EFF_VOXEL)


def plan_stream(
    net_config: dict,
    volume_vox_shape,
    max_eff_voxels: Optional[int] = None,
    min_step_z: int = 24,
    max_step_z: int = 64,
    min_columns: int = 1,
    device=None,
) -> tuple:
    """Pick ``(shape_increase, step_z, warm_step_z)`` for streaming.

    The search of the JAX package: the widest xy whose steady graph fits
    ``max_eff_voxels`` effective input voxels ``(s + 8) * xy_in**2`` at
    ``min_step_z`` (and keeps ``min_columns`` xy columns), then the
    largest step up to ``max_step_z`` at that width; shallow volumes cap
    the step so a stream takes at least two steps.  The warm step is the
    net's base output z, and the steady step a multiple of it, so that the
    write grid stays on output chunks of the warm step's z extent.  The
    default budget is ``device``'s (``default_budget``)."""
    if max_eff_voxels is None:
        max_eff_voxels = default_budget(device)
    base_in = list(net_config["input_shape"])
    base_out = list(net_config["output_shape"])
    if len(base_in) != 3:
        raise ValueError("streaming plans are 3D only")
    vol = list(volume_vox_shape)[-3:]
    step = [1, 1, 1]
    for f in net_config["downsample_factors"]:
        step = [a * b for a, b in zip(step, f)]

    def eff_vox(s, inc_xy):
        return (s + 8) * (base_in[1] + inc_xy) * (base_in[2] + inc_xy)

    def columns(inc_xy):
        t = base_out[1] + inc_xy
        return -(-vol[1] // t) * (-(-vol[2] // t))

    inc_xy = 0
    while True:
        cand = inc_xy + step[1]
        if (
            base_out[1] + cand > min(vol[1], vol[2])
            or columns(cand) < min_columns
            or eff_vox(min_step_z, cand) > max_eff_voxels
        ):
            break
        inc_xy = cand
    s = min_step_z
    while s < max_step_z and eff_vox(s + 1, inc_xy) <= max_eff_voxels:
        s += 1
    s = max(1, min(s, vol[0] // 2 if vol[0] > 1 else 1))
    warm_s = max(1, min(base_out[0], s))
    if s > warm_s:
        s -= s % warm_s
    return [0, inc_xy, inc_xy], s, warm_s


class ZStreamPredictor:
    """Tiled-xy, streamed-z inference for one 3D setup on one device.

    ``model`` holds the weights; it is moved to ``device`` and cast to
    ``compute_dtype`` here, as ``scan.Predictor`` does.  ``step_z`` and
    ``warm_step_z`` set the steady and warm steps' output z (default: the
    tile's output z)."""

    def __init__(
        self,
        model: Model,
        voxel_size,
        shape_increase: Optional[Sequence[int]] = None,
        device=None,
        compute_dtype=torch.bfloat16,
        step_z: Optional[int] = None,
        warm_step_z: Optional[int] = None,
    ):
        if model.dims != 3 or not stream_eligible(model.unet_config):
            raise ValueError(
                "z streaming needs a 3D net that never downsamples z; use scan.Predictor"
            )
        self.device = resolve_device(device)
        self.voxel_size = Coordinate(voxel_size)
        nc = model.net_config
        inc = list(shape_increase) if shape_increase is not None else list(nc.get("shape_increase", [0] * 3))
        in_shape = [a + b for a, b in zip(nc["input_shape"], inc)]
        out_shape = [a + b for a, b in zip(nc["output_shape"], inc)]
        if step_z is not None:
            if step_z < 1:
                raise ValueError(f"step_z must be >= 1, got {step_z}")
            ctx_z = in_shape[0] - out_shape[0]
            out_shape[0] = step_z
            in_shape[0] = step_z + ctx_z
        self.s_warm = warm_step_z if warm_step_z is not None else out_shape[0]
        if not 1 <= self.s_warm <= out_shape[0]:
            raise ValueError(f"warm_step_z must be in [1, {out_shape[0]}], got {warm_step_z}")
        try:
            got = tuple(compute_output_shape(model.unet_config, in_shape))
        except ValueError:
            got = None
        if got != tuple(out_shape):
            raise ValueError(
                f"stream tile {tuple(in_shape)} yields output {got}, expected "
                f"{tuple(out_shape)}: the xy extent must lie on the net's pooling "
                "grid (input xy = base + k * pool-factor product)"
            )
        self.input_tile = tuple(in_shape)
        self.output_tile = tuple(out_shape)
        self.s = out_shape[0]  # z slices per steady step
        self.warm_input_tile = (self.s_warm + in_shape[0] - out_shape[0], *in_shape[1:])
        self.input_size = Coordinate(self.input_tile) * self.voxel_size
        self.output_size = Coordinate(self.output_tile) * self.voxel_size
        self.context = (self.input_size - self.output_size) / 2
        # the z write grid is (offset s_warm, period s): chunks of z extent
        # gcd(s_warm, s) are never straddled
        self.chunk_tile = (math.gcd(self.s_warm, self.s), *self.output_tile[1:])
        model.compute_dtype = compute_dtype
        self.model = model.to(device=self.device, dtype=compute_dtype).eval()
        self._is_image = "raw" in nc.get("inputs", {"raw": {}})
        self._io = DeviceIO(self.device) if self.device.type == "cuda" else None

    @torch.no_grad()
    def step(self, x, state: Optional[dict]):
        """One stream step on the device: uint8 (or float) input slices ->
        ``({head: uint8 outputs}, new state)``; ``state=None`` is the warm
        step."""
        if x.dtype == torch.uint8:
            x = x.to(torch.float32) / 255.0
            if self._is_image:
                x = x * 2.0 - 1.0
        outs, state = self.model.forward_stream(x, state)
        quant = {k: torch.round(torch.clamp(v, 0, 1) * 255).to(torch.uint8) for k, v in outs.items()}
        return quant, state

    def _read_z_reflect(self, arr: Array, roi: Roi) -> np.ndarray:
        """Read ``roi`` reflect-padded about the VOLUME's z boundary.

        ``Array.to_ndarray(pad_mode="reflect")`` reflects about the
        request's in-bounds part, so the stream's last reads, which
        overhang the volume end by more than they hold (or entirely), would
        reflect about the wrong edge or fill with zeros.  An overhanging
        read is extended back into the volume far enough to source the
        reflection, then its z tail is sliced (and the volume start
        likewise)."""
        vz = self.voxel_size[0]
        nz = roi.shape[0] // vz
        end_over = roi.end[0] - arr.roi.end[0]
        beg_over = arr.roi.begin[0] - roi.begin[0]
        if end_over <= 0 and beg_over <= 0:
            return arr.to_ndarray(roi, pad_mode="reflect")
        b, e = roi.begin[0], roi.end[0]
        if end_over > 0:  # include >= overhang + 1 real slices before the end
            b = min(b, arr.roi.end[0] - end_over - vz)
        if beg_over > 0:
            e = max(e, arr.roi.begin[0] + beg_over + vz)
        ext = Roi(Coordinate((b, *roi.begin[1:])), Coordinate((e - b, *roi.shape[1:])))
        x = arr.to_ndarray(ext, pad_mode="reflect")
        z0 = (roi.begin[0] - b) // vz
        return x[..., z0 : z0 + nz, :, :]

    def predict(self, raw, outputs: Dict[str, Array], roi: Optional[Roi] = None) -> dict:
        """Stream ``roi`` (default: the outputs' ROI) column by column,
        writing into ``outputs``.  ``raw`` is one Array or a list whose
        channels are concatenated.  Returns tiles (columns x steps),
        columns, steps per column, seconds, output voxels/s and the plan."""
        inputs = raw if isinstance(raw, (list, tuple)) else [raw]
        total = roi if roi is not None else next(iter(outputs.values())).roi
        vz = self.voxel_size[0]
        t0 = time.perf_counter()

        # xy tiling as scan.Predictor; z walks each column in steps of s
        # output slices, warm step first; the last step's overhang past the
        # volume end is computed from reflect-padded reads and clipped
        yx_total = Roi(total.begin[1:], total.shape[1:])
        yx_tiles = tile_rois(yx_total, Coordinate(self.output_size[1:]))
        n_z = total.shape[0] // vz
        n_steady = max(0, -(-(n_z - self.s_warm) // self.s))
        z_offsets = [(0, self.s_warm * vz)]
        z_offsets += [((self.s_warm + k * self.s) * vz, self.s * vz) for k in range(n_steady)]
        # (is_warm, [write roi], [write clip])
        items = [
            (
                k == 0,
                [Roi(Coordinate((total.begin[0] + dz, *yx.begin)), Coordinate((zext, *yx.shape)))],
                [total],
            )
            for yx in yx_tiles
            for k, (dz, zext) in enumerate(z_offsets)
        ]
        xy_ctx = Coordinate((0, *self.context[1:]))
        z_shift = Coordinate((self.context[0], 0, 0))

        def read_item(item):
            is_warm, (wroi,), _ = item
            if is_warm:
                read_roi = wroi.grow(self.context, self.context)
            else:
                # a steady step continues the input stream: its s new input
                # slices trail the write window by the right-hand z context
                read_roi = wroi.grow(xy_ctx, xy_ctx).shift(z_shift)
            x = read_inputs(inputs, read_roi, self._is_image, read=self._read_z_reflect)
            return is_warm, x[None]

        writer = TileWriter(outputs, self.model.net_config["outputs"], self.voxel_size, clip_roi=total)
        state = None

        def dispatch(read):
            nonlocal state
            is_warm, arr = read

            def run(x):
                nonlocal state
                if is_warm:
                    state = None  # drop the last column's caches first
                outs, state = self.step(x, state)
                return outs

            if self._io is None:
                return None, run(torch.from_numpy(arr))
            return self._io.run(arr, run)

        def drain(item, handle):
            event, outs = handle
            if event is not None:
                event.synchronize()
            writer.drain_batch(item[1], {k: v.numpy() for k, v in outs.items()}, clips=item[2])

        run_pipelined(items, read=read_item, dispatch=dispatch, drain=drain)
        state = None  # free the device caches
        dt = time.perf_counter() - t0
        out_voxels = len(yx_tiles) * n_z * int(np.prod(self.output_tile[1:]))
        return {
            "tiles": len(yx_tiles) * len(z_offsets),
            "columns": len(yx_tiles),
            "z_segments": 1,
            "steps_per_column": len(z_offsets),
            "seconds": dt,
            "voxels_per_sec": out_voxels / dt,
            "input_tile": list(self.input_tile),
            "step_z": self.s,
            "warm_step_z": self.s_warm,
        }
