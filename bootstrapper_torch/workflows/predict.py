"""Prediction workflow: TOML config -> tiled inference (the JAX package's
``workflows/predict.py``), for unchained image setups.

The config is the JAX package's: ``[predict.<volume>]`` (or top-level
``[<volume>]``) tables with ``raw_dataset``, ``output_container``,
optional ``roi_offset``/``roi_shape``, and a one-link ``chain`` of
``{setup_dir, output_prefix, checkpoint_iteration}``.  Chained refiners
and z-streaming are not ported yet.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import torch

from ..core.arrays import open_ds
from ..core.geometry import Roi
from ..models.model import Model
from ..models.weights import latest_checkpoint, load_checkpoint, load_params
from ..predict.scan import Predictor, prepare_prediction_outputs, shrink_shape_increase
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


def run_prediction(
    config_file: str,
    volume: Optional[str] = None,
    roi_offset=None,
    roi_shape=None,
    device=None,
    compute_dtype=torch.bfloat16,
) -> dict:
    """Predict every volume of the config; returns per-volume stats
    (tiles, seconds, output voxels/s)."""
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
        predictor = Predictor(
            model,
            raw.voxel_size,
            shape_increase=shrink_shape_increase(model, out_vox),
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
