"""Whole-volume prediction cells: passes of the one-device predictor over
a raw volume, back to back, then a sample of every pass's outputs held
against the plain reference.

The predictor is built as ``workflows/predict.py:run_prediction`` builds it
for one device with no options: the tile fitted to the volume
(``shrink_shape_increase``), the z stream where ``_maybe_zstream`` takes it
(a 3D net that never pools z, over a volume deeper than one tile), else
the tiled ``Predictor`` (a 2D net's sections 32 a batch).  Raw is read
from an uncompressed Zarr that set-up writes; outputs go to in-memory
arrays, as a pass writes gigabytes and a window holds several passes.
"""

from __future__ import annotations

import gc
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from . import flops as F
from .data import raw_volume, seed32
from .trace import Tracer, span
from .weights import make_weights, param_specs


def on_cuda(device) -> bool:
    return torch.device(device).type == "cuda"


def sync(device) -> None:
    if on_cuda(device):
        torch.cuda.synchronize()


def compute_dtype(cfg: dict):
    """The precision the configuration runs its convs in (bf16 unless it
    says otherwise)."""
    return getattr(torch, cfg.get("compute_dtype", "bfloat16"))


def build_model(cfg: dict, weights: dict, device):
    """The program's ``Model`` of the configuration, holding ``weights``
    (its parameter list checked against the harness's first)."""
    from bootstrapper_torch.models.model import Model

    net_config = cfg["net_config"]
    with torch.device(device):
        model = Model(net_config, compute_dtype=compute_dtype(cfg))
    got = [(n, tuple(p.shape)) for n, p in model.named_parameters()]
    want = [(n, tuple(s)) for n, s in param_specs(net_config)]
    if got != want:
        raise RuntimeError(f"the program's parameters {got[:3]}... are not the harness's {want[:3]}...")
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(weights[n])
    return model


def build_predictor(model, raw, out_vox, device, dtype):
    """``run_prediction``'s one-device predictor (no ``batch_tiles``, no
    ``auto_tile``), from the program's own functions: ``(predictor,
    "stream" or "tiled")``."""
    from bootstrapper_torch.predict.scan import Predictor, shrink_shape_increase
    from bootstrapper_torch.workflows.predict import _maybe_zstream

    nc = model.net_config

    def fit_tile(inc):
        return shrink_shape_increase(model, out_vox, inc)

    fitted = fit_tile(None)
    dev = torch.device(device)
    predictor = _maybe_zstream(model, raw, out_vox, fit_tile, nc["output_shape"][0] + fitted[0], dtype, [dev])
    if predictor is not None:
        return predictor, "stream"
    return Predictor(model, raw.voxel_size, shape_increase=fitted, device=dev, compute_dtype=dtype), "tiled"


def computed_voxels(predictor, stats: dict) -> int:
    """Output voxels one pass computes: a stream's columns times the z its
    steps cover times the tile's xy, or the tiles (a short last batch
    padded to a whole one) times the tile."""
    tile = predictor.output_tile
    if "columns" in stats:
        z = stats["warm_step_z"] + (stats["steps_per_column"] - 1) * stats["step_z"]
        return stats["columns"] * stats["z_segments"] * z * int(np.prod(tile[1:]))
    batches = -(-stats["tiles"] // predictor.batch_tiles)
    return batches * predictor.batch_tiles * int(np.prod(tile))


def axis_starts(extent: int, tile: int) -> list:
    """Tile starts along one axis as the predictors place them: whole tiles
    from 0, the last one shifted inward to end at the volume's end."""
    starts = list(range(0, extent - tile + 1, tile)) or [0]
    if starts[-1] + tile < extent:
        starts.append(extent - tile)
    return starts


def sample_blocks(rng, axes: list, n_blocks: int) -> list:
    """Blocks of outputs the reference recomputes, drawn by ``rng``.

    Per axis, ``axes`` gives the volume's output ``extent``, the ``tile``
    (the extent whose edges the outputs depend on, through the upsample's
    edge clamp), the ``block`` (the output of one reference forward), its
    grid ``step`` (the pooling product) and the edge ``reach``
    (``reference.unet.edge_reach``).  The predictors write whole tiles in
    order, so a voxel holds what the last tile over it wrote: along each
    axis, the one with the largest start.  A block lies in one tile at an
    offset on its grid; it is kept where it is that tile's and, on a side
    that is no edge of the tile, past the reach.  Each axis's tiles are
    drawn in turn twice before the rest are drawn at random, so that the
    edge tiles are covered.  Returns per block and axis ``{"start",
    "extent", "keep": (lo, hi)}`` in output voxels of the volume."""
    blocks = []
    for k in range(n_blocks):
        spec = []
        for ax in axes:
            starts = axis_starts(ax["extent"], ax["tile"])
            t_i = k % len(starts) if k < 2 * len(starts) else int(rng.integers(len(starts)))
            t0 = starts[t_i]
            own_hi = starts[t_i + 1] if t_i + 1 < len(starts) else ax["extent"]
            own = (t0, min(own_hi, t0 + ax["tile"]))
            point = int(rng.integers(*own))
            last = ax["tile"] - ax["block"]
            if last % ax["step"]:
                raise ValueError(f"a block of {ax['block']} does not lie on the grid of a tile of {ax['tile']}")

            def kept(o):
                lo = t0 + o + (0 if o == 0 else ax["reach"])
                hi = t0 + o + ax["block"] - (0 if o == last else ax["reach"])
                return max(lo, own[0]), min(hi, own[1])

            good = [o for o in range(0, last + 1, ax["step"]) if kept(o)[0] <= point < kept(o)[1]]
            o = good[int(rng.integers(len(good)))]
            spec.append({"start": t0 + o, "extent": ax["block"], "keep": kept(o)})
        blocks.append(spec)
    return blocks


def block_axes(nc: dict, vol, tile) -> tuple:
    """``(axes for sample_blocks, input context per axis z, y, x)``: a 3D
    stream is exact in z (no tile edge there), a 2D net's tile is one
    section that reads ``adj_slices``; a block is the setup's own tile
    (``output_shape + shape_increase``), at most the predictor's."""
    from reference.unet import edge_reach

    dims = len(nc["input_shape"])
    reach = edge_reach(nc)
    ctx = F.context(nc)
    inc = nc.get("shape_increase", [0] * dims)
    own = [o + i for o, i in zip(nc["output_shape"], inc)]
    steps = [int(np.prod([f[a] for f in nc["downsample_factors"]])) for a in range(dims)]
    if dims == 3:
        z = {"extent": vol[0], "tile": vol[0], "block": own[0], "step": 1, "reach": 0}
    else:
        z = {"extent": vol[0], "tile": 1, "block": 1, "step": 1, "reach": 0}
        ctx = [nc.get("adj_slices", 1) - 1, *ctx]
    axes = [z] + [
        {"extent": vol[a], "tile": tile[a], "block": min(own[a - 3], tile[a]), "step": steps[a - 3],
         "reach": reach[a]}
        for a in (1, 2)
    ]
    return axes, ctx


def run(cell: dict, cfg: dict, traffic: dict, seed: int, seconds: float, trace: bool, device, t_start: float,
        out: dict, quantize=None) -> dict:
    """One run of a prediction cell; fills and returns ``out``.  ``quantize``
    (the control's runs): the reference in that precision takes the
    program's place over the sampled blocks, and there is no window."""
    from bootstrapper_torch.core.arrays import Array, prepare_ds
    from bootstrapper_torch.core.geometry import Coordinate, Roi
    from bootstrapper_torch.models.model import head_dims
    from bootstrapper_torch.ops import conv3d_kernel_launches, reset_launch_counts

    nc = cfg["net_config"]
    vol = tuple(traffic["volume"])
    vs = Coordinate(traffic["voxel_size"])
    raw_np = raw_volume(vol, seed, device)
    work = tempfile.mkdtemp(prefix="bmk_raw_", dir=os.environ.get("TMPDIR"))
    try:
        raw = prepare_ds(os.path.join(work, "raw.zarr", "raw"), vol, (0, 0, 0), vs, np.uint8)
        raw[raw.roi] = raw_np
        model = build_model(cfg, make_weights(nc, seed32(seed, 0), device), device)
        predictor, route = build_predictor(model, raw, vol, device, compute_dtype(cfg))
        if route != traffic["route"]:
            raise RuntimeError(f"{cell['name']}: the program takes the {route} route, the traffic asks for {traffic['route']}")
        tile = predictor.output_tile
        axes, ctx = block_axes(nc, vol, tile)
        blocks = sample_blocks(np.random.default_rng(seed32(seed, 5)), axes, int(traffic["check_blocks"]))
        if quantize is not None:
            # the control: the reference in ``quantize`` in the program's place
            del predictor, model
            got = reference_blocks(nc, blocks, raw_np, ctx, seed, device, quantize)
            out.update(setup_s=0.0, window_s=0.0, attempted=0, failed=0, memory_peak_bytes=0, e2e={})
            out["numbers"] = check_blocks(nc, blocks, [[g] for g in got], raw_np, ctx, seed, device)
            return out
        outputs = {
            name: Array.from_ndarray(np.full((head_dims(o), *vol), 0, dtype=np.uint8), (0, 0, 0), vs)
            for name, o in nc["outputs"].items()
        }
        # warm-up: every shape a pass runs, each in both of the pipeline's
        # two staging slots, over the least ROI that runs them: a stream's
        # warm step and two steady ones in each of two columns, two batches
        # of sections
        if route == "stream":
            warm = (min(predictor.s_warm + 2 * predictor.s, vol[0]), tile[1], vol[2])
        else:
            warm = (min(2 * predictor.batch_tiles, vol[0]), *tile[1:])
        predictor.predict(raw, outputs, Roi((0, 0, 0), Coordinate(warm) * vs))

        # the outputs the reference recomputes, zeroed before every pass
        keeps = [tuple(slice(*b["keep"]) for b in blk) for blk in blocks]
        snaps = [[] for _ in blocks]

        def zero_kept():
            for sl in keeps:
                for arr in outputs.values():
                    arr.store.data[(slice(None),) + sl] = 0

        def snapshot():
            for j, sl in enumerate(keeps):
                snaps[j].append({n: arr.store.data[(slice(None),) + sl].copy() for n, arr in outputs.items()})

        volume_roi = Roi((0, 0, 0), Coordinate(vol) * vs)
        zero_kept()
        sync(device)
        t_w0 = time.perf_counter()
        pass_s = []
        while True:
            t = time.perf_counter()
            with span("bmk.pass"):
                stats = predictor.predict(raw, outputs, volume_roi)
            pass_s.append(time.perf_counter() - t)
            snapshot()
            if time.perf_counter() - t_w0 >= seconds:
                break
            zero_kept()
        t_w1 = time.perf_counter()
        passes = len(pass_s)
        out["pass_s"] = pass_s
        vol_voxels = int(np.prod(vol))
        out.update(
            setup_s=t_w0 - t_start,
            window_s=t_w1 - t_w0,
            attempted=passes,
            failed=0,
            memory_peak_bytes=torch.cuda.max_memory_allocated(device) if on_cuda(device) else 0,
            e2e={"predict_mvox_per_s": passes * vol_voxels / (t_w1 - t_w0) / 1e6},
        )
        record = {
            "kind": "predict",
            "window_s": t_w1 - t_w0,
            "passes": passes,
            "least_flops_per_pass": F.least_volume_flops(nc, vol),
            "computed_voxels_per_pass": computed_voxels(predictor, stats),
            "volume_voxels": vol_voxels,
            "trace": None,
            "k1_launches": None,
        }
        if trace:
            # one more whole pass, profiled, with the conv kernel's launches
            reset_launch_counts()
            tracer = Tracer(device)
            with tracer:
                with span("bmk.pass"):
                    predictor.predict(raw, outputs, volume_roi)
            record["trace"] = tracer.events
            record["k1_launches"] = conv3d_kernel_launches()
        out["record"] = record
        out["plan"] = {"route": route, "output_tile": list(tile), **{
            k: stats[k] for k in ("tiles", "columns", "steps_per_column", "step_z", "warm_step_z") if k in stats
        }}

        # the program's state goes before the reference runs
        del predictor, model, outputs
        gc.collect()
        if on_cuda(device):
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        out["numbers"] = check_blocks(nc, blocks, snaps, raw_np, ctx, seed, device)
        out["check_s"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


def reference_blocks(nc, blocks, raw_np, ctx_zyx, seed, device, quantize=None) -> list:
    """Per block, ``{head: uint8 outputs}`` of the reference over its kept
    region (``quantize``: the reference's precision, fp32 by default)."""
    from reference.unet import UNetReference, no_tf32

    no_tf32()
    ref = UNetReference(nc, make_weights(nc, seed32(seed, 0), device), quantize=quantize)
    padded = np.pad(raw_np, [(c // 2, c - c // 2) for c in ctx_zyx], mode="reflect")
    dims = len(nc["input_shape"])
    got = []
    with torch.no_grad():
        for blk in blocks:
            (z0, y0, x0), (bz, by, bx) = (b["start"] for b in blk), (b["extent"] for b in blk)
            x = padded[z0 : z0 + bz + ctx_zyx[0], y0 : y0 + by + ctx_zyx[1], x0 : x0 + bx + ctx_zyx[2]]
            t = torch.from_numpy(np.ascontiguousarray(x)).to(device).to(torch.float32) / 255.0 * 2.0 - 1.0
            t = t[None, None] if dims == 3 else t[None, :, None]  # a 2D net: sections as channels
            keep = (slice(None),) + tuple(slice(b["keep"][0] - b["start"], b["keep"][1] - b["start"]) for b in blk)
            got.append({
                name: torch.round(torch.clamp(y[0], 0, 1) * 255).to(torch.uint8).cpu().numpy()[keep]
                for name, y in ref.forward(t).items()
            })
    return got


#: the gaps, in uint8 levels, whose shares of the compared values are
#: numbers of the check
SHARE_AT_LEAST = (2, 3, 8)


def check_blocks(nc, blocks, snaps, raw_np, ctx_zyx, seed, device) -> dict:
    """The fp32 reference over every block, held against every pass's
    snapshot of it: the largest and the mean gap of the uint8 outputs, and
    the shares of the values ``SHARE_AT_LEAST`` levels off or more."""
    total, count, top = 0, 0, 0
    over = dict.fromkeys(SHARE_AT_LEAST, 0)
    for want, per_pass in zip(reference_blocks(nc, blocks, raw_np, ctx_zyx, seed, device), snaps):
        for snap in per_pass:
            for name, w in want.items():
                d = np.abs(snap[name].astype(np.int16) - w.astype(np.int16))
                total += int(d.sum())
                count += d.size
                top = max(top, int(d.max()))
                for t in over:
                    over[t] += int((d >= t).sum())
    count = max(count, 1)
    return {"max_abs_u8": top, "mean_abs_u8": total / count, "compared_values": count,
            **{f"share_ge{t}": n / count for t, n in over.items()}}
