"""Prediction workflow: TOML config -> inference (the JAX package's
``workflows/predict.py``, one device), for unchained image setups.

The config is the JAX package's: ``[predict.<volume>]`` (or top-level
``[<volume>]``) tables with ``raw_dataset``, ``output_container``,
optional ``roi_offset``/``roi_shape``, and a one-link ``chain`` of
``{setup_dir, output_prefix, checkpoint_iteration}``.

As in the JAX package, a volume deeper than one tiled z pass is streamed
in z (``predict/zstream.py``) when the net never pools z; other volumes
are tiled (``predict/scan.py``).  ``BS_ZSTREAM=0`` in the environment
opts out of streaming.  Chained refiners are not ported yet.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import torch

from .. import resolve_device
from ..core.arrays import open_ds
from ..core.geometry import Roi
from ..models.model import Model
from ..models.weights import latest_checkpoint, load_checkpoint, load_params
from ..models.zstream import stream_eligible
from ..predict.scan import Predictor, prepare_prediction_outputs, shrink_shape_increase
from ..predict.zstream import ZStreamPredictor, plan_stream
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


def _maybe_zstream(model, raw, out_vox, tiled_out_z, device, compute_dtype):
    """A ``ZStreamPredictor`` where overlap-save z streaming applies, else
    None (the JAX package's ``_maybe_zstream`` on one device).

    Streaming needs a 3D net that never pools z and a volume deeper than
    one tiled z pass (``tiled_out_z``: one tiled pass already pays the z
    context once).  The stream plans its own tile (``plan_stream``): the z
    step is free, so the memory it frees pays for wider xy tiles."""
    if os.environ.get("BS_ZSTREAM", "1") != "1":
        return None
    if model.dims != 3 or not stream_eligible(model.unet_config):
        return None
    if out_vox[0] <= tiled_out_z:
        return None
    inc, step, warm = plan_stream(model.net_config, out_vox, device=resolve_device(device))
    predictor = ZStreamPredictor(
        model,
        raw.voxel_size,
        shape_increase=shrink_shape_increase(model, out_vox, inc),
        device=device,
        compute_dtype=compute_dtype,
        step_z=step,
        warm_step_z=warm,
    )
    logger.info(
        "z-streaming inference (%d-slice steps, %s input tile)",
        predictor.s,
        "x".join(map(str, predictor.input_tile)),
    )
    return predictor


def run_prediction(
    config_file: str,
    volume: Optional[str] = None,
    roi_offset=None,
    roi_shape=None,
    device=None,
    compute_dtype=torch.bfloat16,
) -> dict:
    """Predict every volume of the config; returns per-volume stats
    (tiles, seconds, output voxels/s; a stream adds its columns, steps
    per column and plan)."""
    cfg = tomlio.load(config_file)
    cfg = cfg.get("predict", cfg)
    results = {}
    for volume_name, vcfg in cfg.items():
        if volume is not None and volume_name != volume:
            continue
        if len(vcfg["chain"]) != 1:
            raise NotImplementedError(
                "chained prediction is not ported yet; give one chain link"
            )
        link = vcfg["chain"][0]
        raw = open_ds(vcfg["raw_dataset"])
        roi = None
        if roi_offset is not None:
            roi = Roi(roi_offset, roi_shape)
        elif "roi_offset" in vcfg:
            roi = Roi(vcfg["roi_offset"], vcfg["roi_shape"])
        setup_dir = link["setup_dir"]
        model = Model.from_setup(setup_dir, compute_dtype=compute_dtype)
        if "raw" not in model.net_config.get("inputs", {"raw": {}}):
            raise NotImplementedError(
                f"{setup_dir} takes predictions as input; refiners are not "
                "ported yet"
            )
        ckpt = _find_checkpoint(setup_dir, link.get("checkpoint_iteration", "latest"))
        load_params(model, load_checkpoint(ckpt))
        out_roi = raw.roi if roi is None else roi
        out_vox = tuple(s // v for s, v in zip(out_roi.shape, raw.voxel_size))
        fitted = shrink_shape_increase(model, out_vox)
        predictor = _maybe_zstream(
            model,
            raw,
            out_vox,
            model.net_config["output_shape"][0] + fitted[0],
            device,
            compute_dtype,
        ) or Predictor(
            model,
            raw.voxel_size,
            shape_increase=fitted,
            device=device,
            compute_dtype=compute_dtype,
        )
        if any(s < m for s, m in zip(out_roi.shape, predictor.output_size)):
            raise ValueError(
                f"roi {out_roi} smaller than one output tile {predictor.output_size}"
            )
        outputs = prepare_prediction_outputs(
            vcfg["output_container"],
            model,
            out_roi,
            raw.voxel_size,
            predictor,
            dataset_prefix=link["output_prefix"] + "/",
        )
        stats = predictor.predict(raw, outputs, out_roi)
        logger.info(
            "%s / %s: %d tiles, %.2f Mvox/s",
            volume_name,
            os.path.basename(setup_dir),
            stats["tiles"],
            stats["voxels_per_sec"] / 1e6,
        )
        results[f"{volume_name}/{link['output_prefix']}"] = stats
    return results
