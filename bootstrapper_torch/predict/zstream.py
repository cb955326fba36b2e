"""Z-streaming prediction: overlap-save inference over deep volumes (the
JAX package's ``predict/zstream.py``), on one device or on several in
lockstep.

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

Over several devices, columns stream in lockstep, one per device, and a
deep volume with fewer xy columns than devices splits each column's z walk
into segments (``plan_z_groups``), each a stream of its own.
"""

from __future__ import annotations

import math
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .. import resolve_device, resolve_devices
from ..core.arrays import Array
from ..core.geometry import Coordinate, Roi
from ..models.model import Model
from ..models.unet import compute_output_shape
from ..models.zstream import stream_eligible
from ..utils.profiling import span
from ._pipeline import Lane, TileWriter, dispatch_lanes, fetch, read_inputs, run_pipelined
from .scan import DEFAULT_DEVICE_BYTES, device_memory_bytes, normalize_on_device, quantize, tile_rois

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
    """Pick ``(shape_increase, step_z, warm_step_z)`` for streaming: the
    plan that computes the fewest input voxels over the volume.

    The candidate xy increases are those on the pooling grid whose output
    tile is no wider than the volume, which keep ``min_columns`` xy
    columns, and whose steady graph fits ``max_eff_voxels`` effective input
    voxels ``(s + 8) * xy_in**2`` at ``min_step_z`` (the JAX package takes
    the widest of them).  At each, the z step is the one from
    ``min_step_z`` up to ``max_step_z``, the budget's largest and half the
    volume's z (so that a stream takes at least two steps) whose steps
    cover the fewest slices; shallow volumes take that cap.  The warm step
    is the net's base output z, and the steady step a multiple of it, so
    that the write grid stays on output chunks of the warm step's z
    extent.  A plan costs columns x input xy area x z slices covered; ties
    go to fewer steps, then the wider tile.  A tile that covers the volume
    evenly keeps the JAX package's plan; a wide tile that overhangs the
    volume by a few voxels gives way to a narrower one with the same
    columns.  The default budget is ``device``'s (``default_budget``)."""
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

    def warm(s):
        return max(1, min(base_out[0], s))

    def z_covered(s):
        return warm(s) + max(0, -(-(vol[0] - warm(s)) // s)) * s

    incs = [0]
    while True:
        cand = incs[-1] + step[1]
        if (
            base_out[1] + cand > min(vol[1], vol[2])
            or columns(cand) < min_columns
            or eff_vox(min_step_z, cand) > max_eff_voxels
        ):
            break
        incs.append(cand)
    z_cap = vol[0] // 2 if vol[0] > 1 else 1
    best = None
    for inc_xy in incs:
        top = min_step_z
        while top < max_step_z and eff_vox(top + 1, inc_xy) <= max_eff_voxels:
            top += 1
        hi = max(1, min(top, z_cap))
        steps = [s for s in range(min_step_z, hi + 1) if s % warm(s) == 0]
        if not steps:  # shallow: the cap, on the warm step's grid
            steps = [hi - hi % warm(hi)]
        for s in steps:
            z = z_covered(s)
            n_steps = 1 + (z - warm(s)) // s
            key = (columns(inc_xy) * (base_in[1] + inc_xy) * (base_in[2] + inc_xy) * z, n_steps, -inc_xy)
            if best is None or key < best[0]:
                best = (key, inc_xy, s)
    _, inc_xy, s = best
    return [0, inc_xy, inc_xy], s, warm(s)


#: a warm step's device time over its share of a steady step's by slices,
#: ``warm_ms / (steady_ms * (s_warm + ctx_z) / s)``: the warm step computes
#: its whole ``s_warm + ctx_z`` input slices, but only a thin output window.
#: Measured by ``chip_smoke.py``'s ``multi`` phase on an NVIDIA H100 80GB
#: HBM3 (power limit 700.00 W), full-width 3d_affs, xy 732: a warm step of
#: 4 (32 input slices) 125.0 ms, a steady step of 64 579.3 ms, 0.432
WARM_COST_FACTOR = 0.43


def plan_z_groups(
    n_z_slices: int,
    n_cols: int,
    n_dev: int,
    s: int,
    s_warm: int,
    ctx_z: int,
    max_groups: int = 64,
    warm_cost_factor: float = WARM_COST_FACTOR,
) -> tuple:
    """Split each xy column's z walk into ``G`` segments streamed on
    separate devices (the JAX package's ``plan_z_groups``), so that a
    deep volume with fewer xy columns than devices still fills them.

    Each segment pays a warm step once, so G trades the devices' use
    against recomputed z context.  Estimated lockstep time, in steady
    steps: ``cost(G) = n_groups(G) * (n_steady(G) + warm_cost)`` with
    ``n_groups = ceil(n_cols * G / n_dev)``, ``n_steady = ceil((seg -
    s_warm) / s)``, ``seg = ceil(n_z / G)`` rounded up to a multiple of
    ``s_warm`` and ``warm_cost = warm_cost_factor * (s_warm + ctx_z) / s``.

    Returns ``(G, seg_slices, overhead_factor)``: the factor is device
    slices dispatched per useful output slice (``cost * s * n_dev /
    (n_cols * n_z)``), for comparison with the tiled path's z context
    factor.  One device always plans G = 1."""
    if n_z_slices < 1 or n_cols < 1:
        raise ValueError("need a non-empty volume")
    warm_cost = warm_cost_factor * (s_warm + ctx_z) / s
    best = None
    g_cap = max(1, min(max_groups, n_z_slices // max(1, s_warm)))
    for g in range(1, g_cap + 1):
        seg = -(-(-(-n_z_slices // g)) // s_warm) * s_warm
        if (g - 1) * seg >= n_z_slices:
            continue  # the last segment would be empty
        n_steady = max(0, -(-(seg - s_warm) // s))
        n_groups = -(-(n_cols * g) // n_dev)
        cost = n_groups * (n_steady + warm_cost)
        if best is None or cost < best[0]:
            best = (cost, g, seg)
    cost, g, seg = best
    factor = cost * s * n_dev / (n_cols * n_z_slices)
    return g, seg, factor


class ZStreamPredictor:
    """Tiled-xy, streamed-z inference for one 3D setup.

    ``model`` holds the weights; on one ``device`` it is moved there and
    cast to ``compute_dtype``, as ``scan.Predictor`` does.  With
    ``devices`` (``resolve_devices``'s list; an entry may repeat) each
    device entry gets a replica and ``len(devices)`` columns stream in
    lockstep, one per device (``predict``).  ``step_z`` and ``warm_step_z``
    set the steady and warm steps' output z (default: the tile's output
    z)."""

    def __init__(
        self,
        model: Model,
        voxel_size,
        shape_increase: Optional[Sequence[int]] = None,
        device=None,
        compute_dtype=torch.bfloat16,
        step_z: Optional[int] = None,
        warm_step_z: Optional[int] = None,
        devices: Optional[Sequence] = None,
    ):
        if model.dims != 3 or not stream_eligible(model.unet_config):
            raise ValueError(
                "z streaming needs a 3D net that never downsamples z; use scan.Predictor"
            )
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
        self._is_image = "raw" in nc.get("inputs", {"raw": {}})
        if devices is None:  # one device: the caller's model, moved there
            self.lanes = [Lane.adopt(model, resolve_device(device), compute_dtype)]
        else:  # lockstep: a replica per device entry
            self.lanes = [Lane(model, d, compute_dtype) for d in resolve_devices(devices)]
        self.B = len(self.lanes)
        self.devices = [lane.device for lane in self.lanes]
        self.device, self.model = self.lanes[0].device, self.lanes[0].model

    @torch.no_grad()
    def step(self, x, state: Optional[dict], lane: int = 0):
        """One stream step on lane ``lane``'s device: uint8 (or float) input
        slices -> ``({head: uint8 outputs}, new state)``; ``state=None`` is
        the warm step."""
        model = self.lanes[lane].model
        outs, state = model.forward_stream(normalize_on_device(x, self._is_image), state)
        return quantize(outs), state

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
        columns, z segments, steps per column, devices, seconds, the ROI's
        output voxels/s, the plan and the conv kernel's launches per device.

        Over ``B`` devices, B virtual columns stream in lockstep, each on
        its own device with its caches there; a short last group is padded
        with copies of its last column, whose outputs are not written.
        Where there are fewer xy columns than devices, each column's z walk
        splits into ``plan_z_groups`` segments, each a stream of its own
        with its own warm step; an inner segment's writes are clipped at
        its end, where the next segment's begin (the two compute those
        slices alike, but only one may own them)."""
        inputs = raw if isinstance(raw, (list, tuple)) else [raw]
        total = roi if roi is not None else next(iter(outputs.values())).roi
        vz = self.voxel_size[0]
        B = self.B
        t0 = time.perf_counter()

        # xy tiling as scan.Predictor; z walks each virtual column in steps
        # of s output slices, warm step first; a step's overhang past its
        # segment or the volume is computed from reflect-padded reads and
        # clipped
        yx_total = Roi(total.begin[1:], total.shape[1:])
        yx_tiles = tile_rois(yx_total, Coordinate(self.output_size[1:]))
        n_z = total.shape[0] // vz
        n_groups_z, seg_slices = 1, n_z
        if B > 1:
            n_groups_z, seg_slices, _ = plan_z_groups(
                n_z, len(yx_tiles), B, self.s, self.s_warm, self.input_tile[0] - self.output_tile[0]
            )
        vcols = []  # (yx roi, segment z start, segment write clip)
        for g in range(n_groups_z):
            z0 = total.begin[0] + g * seg_slices * vz
            z_end = min(z0 + seg_slices * vz, total.end[0]) if g + 1 < n_groups_z else total.end[0]
            clip = Roi(Coordinate((z0, *total.begin[1:])), Coordinate((z_end - z0, *total.shape[1:])))
            vcols += [(yx, z0, clip) for yx in yx_tiles]
        n_steady = max(0, -(-(seg_slices - self.s_warm) // self.s))
        z_offsets = [(0, self.s_warm * vz)]
        z_offsets += [((self.s_warm + k * self.s) * vz, self.s * vz) for k in range(n_steady)]
        # (is_warm, [write roi per column], [write clip per column])
        items = [
            (
                k == 0,
                [Roi(Coordinate((z0 + dz, *yx.begin)), Coordinate((zext, *yx.shape))) for yx, z0, _ in grp],
                [c for _, _, c in grp],
            )
            for grp in (vcols[i : i + B] for i in range(0, len(vcols), B))
            for k, (dz, zext) in enumerate(z_offsets)
        ]
        xy_ctx = Coordinate((0, *self.context[1:]))
        z_shift = Coordinate((self.context[0], 0, 0))

        def read_window(wroi, is_warm):
            if is_warm:
                read_roi = wroi.grow(self.context, self.context)
            else:
                # a steady step continues the input stream: its s new input
                # slices trail the write window by the right-hand z context
                read_roi = wroi.grow(xy_ctx, xy_ctx).shift(z_shift)
            return read_inputs(inputs, read_roi, self._is_image, read=self._read_z_reflect)[None]

        def read_item(item):
            is_warm, wrois, _ = item
            arrs = [read_window(w, is_warm) for w in wrois]
            return is_warm, arrs + arrs[-1:] * (B - len(arrs))  # pad; extras not written

        writer = TileWriter(outputs, self.model.net_config["outputs"], self.voxel_size, clip_roi=total)
        states = [None] * B
        launches = [0] * B

        def dispatch(read):
            is_warm, arrs = read

            def run(x, k):
                if is_warm:
                    states[k] = None  # drop the last column's caches first
                outs, states[k] = self.step(x, states[k], lane=k)
                return outs

            fns = [lambda x, k=k: run(x, k) for k in range(B)]
            with span("bs.zstream.warm" if is_warm else "bs.zstream.steady"):
                return dispatch_lanes(self.lanes, arrs, fns, launches)  # queued; waited for in drain

        def drain(item, handles):
            _, wrois, clips = item
            for j, wroi in enumerate(wrois):
                outs = fetch(handles[j])
                writer.drain_batch([wroi], outs, clips=[clips[j]])

        run_pipelined(items, read=read_item, dispatch=dispatch, drain=drain)
        states = None  # free the device caches
        dt = time.perf_counter() - t0
        out_voxels = int(np.prod(Coordinate(total.shape) / self.voxel_size))
        return {
            "tiles": len(vcols) * len(z_offsets),
            "columns": len(yx_tiles),
            "z_segments": n_groups_z,
            "steps_per_column": len(z_offsets),
            "devices": B,
            "seconds": dt,
            "voxels_per_sec": out_voxels / dt,
            "input_tile": list(self.input_tile),
            "step_z": self.s,
            "warm_step_z": self.s_warm,
            "launches_by_device": launches,
        }
