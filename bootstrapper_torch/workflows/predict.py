"""Prediction workflow: TOML config -> chained inference (the JAX
package's ``workflows/predict.py``).

The config is the JAX package's: ``[predict.<volume>]`` (or top-level
``[<volume>]``) tables with ``raw_dataset``, ``output_container``,
optional ``roi_offset``/``roi_shape``, and a ``chain`` of ``{setup_dir,
output_prefix, checkpoint_iteration[, input_datasets]}``: an image model,
then refiners, each reading the previous link's outputs (matched to its
declared inputs by name), which stay in [0, 1] where raw is scaled to
[-1, 1].

``auto_tile`` grows the tile as the JAX package's ``--auto-tile`` does
(``predict/scan.py:auto_shape_increase``), before the tile is fitted to the
volume and before streaming is considered, so that a tile covering the
volume's depth is tiled, not streamed.  ``BS_INT8=1`` predicts with int8
convs (``ops/quant.py``) on every path but the batch-sharded one, as the JAX
package does: each activation scale is taken over the tensor the JAX graph
would quantize (a batch of tiles, one stream step, one slab of a spatially
split tile).  A batch spread over devices would need each conv's amax
exchanged across them (the JAX package's global batch), so
``sharded="batch"`` refuses the flag.

As in the JAX package, a volume deeper than one tiled z pass is streamed
in z (``predict/zstream.py``) when the net is 3D and never pools z; other
volumes, and every 2D link, are tiled (``predict/scan.py``), a 2D link's
sections ``batch_tiles`` at a time.  ``BS_ZSTREAM=0`` in the environment,
or an explicit ``batch_tiles``, opts out of streaming.

``sharded`` spreads each link over several devices, as the JAX package's
``--sharded`` does: lockstep streams or a batch of tiles, one per device
(``"batch"``), or each tile split over them (``"spatial"``).
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import torch

from .. import resolve_devices
from ..core.arrays import open_ds
from ..core.geometry import Roi
from ..models.model import Model
from ..models.weights import latest_checkpoint, load_checkpoint, load_params
from ..models.zstream import stream_eligible
from ..ops.quant import int8_enabled
from ..predict.scan import (
    Predictor,
    auto_shape_increase,
    prepare_prediction_outputs,
    shrink_shape_increase,
)
from ..predict.sharded import ShardedPredictor
from ..predict.spatial import SpatialShardedPredictor, spatial_shape_increase
from ..predict.zstream import ZStreamPredictor, plan_stream, plan_z_groups
from ..utils import tomlio

logger = logging.getLogger(__name__)


def _find_checkpoint(setup_dir: str, iteration) -> str:
    explicit = iteration not in (None, "latest")
    if explicit:
        path = os.path.join(setup_dir, f"model_checkpoint_{iteration}")
        if os.path.exists(path):
            return path
    latest = latest_checkpoint(setup_dir)
    if latest is None:
        raise FileNotFoundError(
            f"no checkpoint in {setup_dir} (wanted iteration {iteration})"
        )
    if explicit:
        logger.warning("checkpoint iteration %s not found; using %s", iteration, latest)
    return latest


def _align_chain_inputs(model, arrays, labels):
    """Match chained input arrays to the model's declared inputs by NAME.

    ``net_config['inputs']`` is an ordered mapping (e.g. 2d_lsds then
    2d_affs for 3d_affs_from_2d_mtlsd); the tile reader concatenates
    arrays positionally, so a reordered ``input_datasets`` list or
    outputs dict would silently swap channel groups — both halves are
    often the same width (6+6), so the conv succeeds and garbage is
    written. The reference matches datasets by name
    (``predict.py:246-265``); same here: reorder by name when every
    declared input matches exactly one array, then validate channel
    widths and fail loudly on a mismatch.
    """
    declared = [
        (k, int(v.get("dims", 1)))
        for k, v in model.net_config.get("inputs", {}).items()
    ]
    if not declared or (len(declared) <= 1 and len(arrays) == 1):
        return arrays, labels

    def _ch(a):
        return a.shape[0] if len(a.shape) == len(a.roi.shape) + 1 else 1

    base = [os.path.basename(os.path.normpath(str(l))) for l in labels]
    picks = []
    for name, _ in declared:
        hits = [i for i, b in enumerate(base) if name in b]
        if len(hits) != 1:
            picks = None
            break
        picks.append(hits[0])
    if picks is not None and len(set(picks)) == len(picks):
        # Name matching also SELECTS when more datasets arrive than the
        # model declares (a refiner taking a subset of the previous
        # setup's outputs, e.g. 2d_mtlsd -> 3d_affs_from_2d_affs).
        arrays = [arrays[i] for i in picks]
        labels = [labels[i] for i in picks]
    elif len(arrays) != len(declared):
        raise ValueError(
            f"chain link expects {len(declared)} input dataset(s) "
            f"{[n for n, _ in declared]} but input_datasets provides "
            f"{len(arrays)} ({list(map(str, labels))}) and they cannot "
            "be matched by name; list exactly the declared inputs (or "
            "name datasets after them)"
        )
    widths = [_ch(a) for a in arrays]
    want = [d for _, d in declared]
    if widths != want:
        raise ValueError(
            f"chain inputs {list(labels)} have channel widths {widths} "
            f"but the model declares inputs {declared}; order "
            "input_datasets to match (or name datasets after the "
            "declared inputs so they can be matched)"
        )
    return arrays, labels


def _maybe_zstream(model, raw, out_vox, fit_tile, tiled_out_z, compute_dtype, devices, tiled_out_xy=None):
    """A ``ZStreamPredictor`` where overlap-save z streaming applies, else
    None (the JAX package's ``_maybe_zstream``).

    Streaming needs a 3D net that never pools z and a volume deeper than
    one tiled z pass (``tiled_out_z``: one tiled pass already pays the z
    context once).  The stream plans its own tile (``plan_stream``): the z
    step is free, so the memory it frees pays for wider xy tiles.

    Over several devices the columns stream in lockstep, and two plans
    compete: xy tiles narrowed until every device gets a column, and the
    widest xy tiles with each column's z walk split into segments
    (``plan_z_groups``).  Each is scored by its device work per output
    voxel (z overhead x xy context x ragged coverage), and the stream is
    taken only if the winner beats the tiled path's; ``BS_ZSTREAM_PLAN``
    (``narrow`` or ``wide``) forces a plan family."""
    if os.environ.get("BS_ZSTREAM", "1") != "1":
        return None
    if model.dims != 3 or not stream_eligible(model.unet_config):
        return None
    if out_vox[0] <= tiled_out_z:
        return None
    nc = model.net_config
    ctx_z = nc["input_shape"][0] - nc["output_shape"][0]
    ctx_xy = nc["input_shape"][1] - nc["output_shape"][1]
    n_dev = len(devices)

    def columns(inc):
        out_shape = [a + b for a, b in zip(nc["output_shape"], inc)]
        n = 1
        for v, t in zip(out_vox[1:], out_shape[1:]):
            n *= -(-v // t)
        return n, out_shape

    plan_force = os.environ.get("BS_ZSTREAM_PLAN", "auto")
    min_cols_cands = {n_dev, 1}
    if plan_force == "narrow":
        min_cols_cands = {n_dev}
    elif plan_force == "wide":
        min_cols_cands = {1}

    cands = []
    for min_cols in min_cols_cands:
        inc, step, warm = plan_stream(nc, out_vox, min_columns=min_cols, device=devices[0])
        inc = fit_tile(inc)
        ncols, out_shape = columns(inc)
        if n_dev > 1:
            _, _, zf = plan_z_groups(out_vox[0], ncols, n_dev, step, warm, ctx_z)
        else:
            zf = 1.0  # one device: the whole volume's stream, no segments
        xyf = ((out_shape[1] + ctx_xy) / out_shape[1]) * ((out_shape[2] + ctx_xy) / out_shape[2])
        # lockstep columns run the full xy tile also where it overhangs the
        # volume, so a plan's device work scales with ncols * tile area
        coverage = (ncols * out_shape[1] * out_shape[2]) / max(out_vox[1] * out_vox[2], 1)
        cands.append((zf * xyf * coverage, inc, step, warm, ncols))
    total, s_inc, s_step, s_warm, n_cols = min(cands)
    if n_dev > 1:
        tiled_total = ((tiled_out_z + ctx_z) / tiled_out_z) * (
            ((tiled_out_xy + ctx_xy) / tiled_out_xy) ** 2 if tiled_out_xy else 1.0
        )
        if tiled_out_xy:
            # the same ragged coverage: edge tiles compute the full tile too
            tiled_total *= (
                -(-out_vox[1] // tiled_out_xy) * tiled_out_xy
                * (-(-out_vox[2] // tiled_out_xy)) * tiled_out_xy
                / max(out_vox[1] * out_vox[2], 1)
            ) * (-(-out_vox[0] // tiled_out_z) * tiled_out_z / out_vox[0])
        if total >= tiled_total:
            logger.info(
                "z-stream overhead %.3f >= tiled %.3f (%d columns / %d devices): tiled sharding instead",
                total, tiled_total, n_cols, n_dev,
            )
            return None
    predictor = ZStreamPredictor(
        model,
        raw.voxel_size,
        shape_increase=s_inc,
        device=devices[0],
        compute_dtype=compute_dtype,
        step_z=s_step,
        warm_step_z=s_warm,
        devices=devices if n_dev > 1 else None,
    )
    logger.info(
        "z-streaming inference over %d device(s) (%d-slice steps, %d columns, %s input tile)",
        n_dev, predictor.s, n_cols, "x".join(map(str, predictor.input_tile)),
    )
    return predictor


def run_prediction(
    config_file: str,
    volume: Optional[str] = None,
    roi_offset=None,
    roi_shape=None,
    setup_id: Optional[str] = None,
    device=None,
    compute_dtype=torch.bfloat16,
    batch_tiles: Optional[int] = None,
    auto_tile: bool = False,
    sharded: Optional[str] = None,
) -> dict:
    """Run the prediction chain of every volume of the config; returns
    per-link stats (tiles, seconds, output voxels/s; a stream adds its
    columns, steps per column and plan).  ``setup_id`` restricts to the
    chain links whose setup name contains it, each reading its configured
    ``input_datasets`` from disk (re-running one setup of a chain).
    ``batch_tiles`` sets the tiled predictor's batch (default 32 tiles
    for a 2D setup, 1 for a 3D one) and, as in the JAX package, tiles
    every link instead of streaming it.  ``auto_tile`` picks each 3D
    link's tile by ``auto_shape_increase`` under ``device``'s budget.

    ``sharded`` spreads each link over the devices of ``device``
    (``resolve_devices``: every visible card by default, or a list such as
    ``"cuda:0,cuda:1"``, in which an entry may repeat): ``"batch"`` streams
    the columns in lockstep where that wins (``_maybe_zstream``), else runs
    a batch of tiles, one per device (``predict/sharded.py``);
    ``"spatial"`` splits each tile over the devices
    (``predict/spatial.py``), at ``spatial_shape_increase``'s tile unless
    ``auto_tile`` picks one.  Unsharded, a link runs on the first device."""
    if sharded not in (None, "batch", "spatial"):
        raise ValueError(f"sharded must be None, 'batch' or 'spatial', not {sharded!r}")
    if sharded == "batch" and int8_enabled():
        raise ValueError(
            "BS_INT8=1 with sharded='batch': the JAX package takes each int8 activation "
            "scale over the batch of all devices, and the port's devices run their tiles "
            "apart (one scale per device); predict unsharded or sharded='spatial', or "
            "unset BS_INT8 (ROADMAP Queue C)"
        )
    devices = resolve_devices(device)
    if len(devices) > 1 and not sharded:
        logger.warning("%d devices given, none sharded over: predicting on %s", len(devices), devices[0])
    cfg = tomlio.load(config_file)
    cfg = cfg.get("predict", cfg)
    results = {}
    for volume_name, vcfg in cfg.items():
        if volume is not None and volume_name != volume:
            continue
        raw = open_ds(vcfg["raw_dataset"])
        roi = None
        if roi_offset is not None:
            roi = Roi(roi_offset, roi_shape)
        elif "roi_offset" in vcfg:
            roi = Roi(vcfg["roi_offset"], vcfg["roi_shape"])

        prev_arrays, prev_labels = [raw], ["raw"]
        for idx, link in enumerate(vcfg["chain"]):
            setup_dir = link["setup_dir"]
            setup_name = os.path.basename(os.path.normpath(setup_dir))
            if setup_id is not None:
                if setup_id not in setup_name:
                    continue
                ins = link.get("input_datasets")
                if ins:
                    prev_arrays = [open_ds(p) for p in ins]
                    prev_labels = list(ins)
                elif idx > 0:
                    # skipped earlier links leave prev_arrays == [raw];
                    # running a refiner on raw would be silently wrong
                    raise ValueError(
                        f"--setup-id {setup_id!r} selects chain link {idx} ({setup_name}) but the "
                        "config has no input_datasets for it; add them so the model gets its real inputs"
                    )
            model = Model.from_setup(setup_dir, compute_dtype=compute_dtype)
            prev_arrays, prev_labels = _align_chain_inputs(model, prev_arrays, prev_labels)
            ckpt = _find_checkpoint(setup_dir, link.get("checkpoint_iteration", "latest"))
            load_params(model, load_checkpoint(ckpt))

            # the output ROI: where every input has data, unless one is given
            in_roi = prev_arrays[0].roi
            for a in prev_arrays[1:]:
                in_roi = in_roi.intersect(a.roi)
            out_roi = in_roi if roi is None else roi
            out_vox = tuple(s // v for s, v in zip(out_roi.shape, raw.voxel_size))
            nc = model.net_config

            def fit_tile(inc):
                return shrink_shape_increase(model, out_vox, inc)

            shape_increase = None
            if auto_tile:
                shape_increase = auto_shape_increase(nc, raw.spatial_shape, device=devices[0])
                logger.info("auto tile: shape_increase=%s", shape_increase)
            if sharded == "spatial":
                if shape_increase is None and model.dims == 3:
                    shape_increase = spatial_shape_increase(nc, len(devices), raw.spatial_shape)
                    logger.info("spatial tile: shape_increase=%s", shape_increase)
                predictor = SpatialShardedPredictor(
                    model, raw.voxel_size, devices=devices, shape_increase=fit_tile(shape_increase),
                    compute_dtype=compute_dtype,
                )
                logger.info(
                    "spatially sharded inference over %d devices (axis %d, halo %s)",
                    len(devices), predictor.shard_axis, predictor.halo,
                )
            elif sharded:
                fitted = fit_tile(shape_increase)
                predictor = _maybe_zstream(
                    model, raw, out_vox, fit_tile, nc["output_shape"][0] + fitted[0], compute_dtype, devices,
                    tiled_out_xy=nc["output_shape"][1] + fitted[1],
                )
                if predictor is None:
                    predictor = ShardedPredictor(
                        model, raw.voxel_size, devices=devices, shape_increase=fitted, compute_dtype=compute_dtype,
                    )
                    logger.info("sharded inference over %d devices", len(devices))
            else:
                fitted = fit_tile(shape_increase)
                predictor = None
                if batch_tiles is None:
                    predictor = _maybe_zstream(
                        model, raw, out_vox, fit_tile, nc["output_shape"][0] + fitted[0], compute_dtype, devices[:1],
                    )
                if predictor is None:
                    predictor = Predictor(
                        model, raw.voxel_size, shape_increase=fitted, batch_tiles=batch_tiles, device=devices[0],
                        compute_dtype=compute_dtype,
                    )
            if any(s < m for s, m in zip(out_roi.shape, predictor.output_size)):
                raise ValueError(f"roi {out_roi} smaller than one output tile {predictor.output_size}")
            outputs = prepare_prediction_outputs(
                vcfg["output_container"], model, out_roi, raw.voxel_size, predictor,
                dataset_prefix=link["output_prefix"] + "/",
            )
            stats = predictor.predict(prev_arrays, outputs, out_roi)
            logger.info(
                "%s / %s: %d tiles, %.2f Mvox/s",
                volume_name, setup_name, stats["tiles"], stats["voxels_per_sec"] / 1e6,
            )
            results[f"{volume_name}/{link['output_prefix']}"] = stats
            prev_arrays, prev_labels = list(outputs.values()), list(outputs.keys())
    return results
