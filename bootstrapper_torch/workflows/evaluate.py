"""Evaluation workflow: discover segmentations, score, dump JSON
(the JAX package's ``workflows/evaluate.py``; prediction errors run on
``device``).

Equivalent of the reference evaluate script (reference
``bootstrapper/evaluate.py:16-159``): find segmentation datasets under a
prefix (skipping ``__vs__`` error outputs), run GT metrics (VOI +
skeletons) and/or self-supervised error maps, write one JSON per
volume.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Optional

from ..core.arrays import open_ds
from ..eval.errors import compute_aff_errors, compute_lsd_errors
from ..eval.metrics import compute_metrics
from ..utils import tomlio

logger = logging.getLogger(__name__)


def get_seg_datasets(prefix: str) -> list:
    """All Zarr arrays under a prefix (dirs containing .zarray),
    skipping ``__vs__`` error-map outputs (``evaluate.py:16-21``)."""
    out = []
    for root, dirs, files in os.walk(prefix):
        if "__vs__" in root:
            continue
        if ".zarray" in files:
            out.append(root)
    return sorted(out)


def run_evaluation(
    config_file: str,
    volume: Optional[str] = None,
    gt_only: bool = False,
    pred_only: bool = False,
    out_result: Optional[str] = None,
    device=None,
) -> dict:
    """``gt_only``/``pred_only`` restrict to one evaluation mode and
    ``out_result`` overrides the result JSON path (reference
    ``evaluate.py:134-140`` option surface).  Prediction errors run on
    ``device`` (``cuda`` unless ``"cpu"`` is asked for)."""
    cfg_all = tomlio.load(config_file)
    cfg_all = cfg_all.get("evaluate", cfg_all)
    all_results = {}
    for volume_name, cfg in cfg_all.items():
        if volume is not None and volume_name != volume:
            continue
        cfg = dict(cfg)
        if gt_only:
            cfg.pop("pred", None)
            cfg.pop("threshold_sweep", None)
        if pred_only:
            cfg.pop("gt", None)
        seg_paths = get_seg_datasets(cfg["seg_datasets_prefix"])
        if not seg_paths:
            logger.warning(
                "no segmentations under %s", cfg["seg_datasets_prefix"]
            )
        results = {}
        mask = (
            open_ds(cfg["mask_dataset"]) if cfg.get("mask_dataset") else None
        )
        for seg_path in seg_paths:
            seg = open_ds(seg_path)
            entry = {}
            if "gt" in cfg:
                gt = cfg["gt"]
                entry.update(
                    compute_metrics(
                        seg,
                        gt_labels=(
                            open_ds(gt["labels_dataset"])
                            if gt.get("labels_dataset")
                            else None
                        ),
                        gt_skeletons=gt.get("skeletons_file"),
                        mask=mask,
                    )
                )
            if "pred" in cfg:
                pred = cfg["pred"]
                pred_ds = open_ds(pred["pred_dataset"])
                params = pred.get("params", {})
                err_container = os.path.join(
                    cfg["out_result_dir"],
                    os.path.basename(seg_path)
                    + "__vs__"
                    + os.path.basename(pred["pred_dataset"]),
                )
                if "lsd_sigma" in params:
                    entry["pred_errors"] = compute_lsd_errors(
                        seg,
                        pred_ds,
                        sigma=params["lsd_sigma"],
                        out_container=err_container,
                        thresholds=tuple(pred.get("thresholds", (0.1, 1.0))),
                        device=device,
                    )
                elif "aff_neighborhood" in params:
                    entry["pred_errors"] = compute_aff_errors(
                        seg,
                        pred_ds,
                        neighborhood=params["aff_neighborhood"],
                        out_container=err_container,
                        thresholds=tuple(pred.get("thresholds", (0.1, 1.0))),
                        device=device,
                    )
            results[seg_path] = entry
        if "threshold_sweep" in cfg:
            # per-threshold LUT sweep over the RAG without extracting
            # segmentations (EvaluateAnnotations capability)
            from ..eval.thresholds import evaluate_thresholds
            from ..post.rag import RagDB

            ts = cfg["threshold_sweep"]
            gt = cfg.get("gt", {})
            sweep = evaluate_thresholds(
                open_ds(ts["fragments_dataset"]),
                RagDB(ts["rag_db"], mode="r"),
                ts.get("thresholds", [0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7]),
                gt_labels=(
                    open_ds(gt["labels_dataset"])
                    if gt.get("labels_dataset")
                    else None
                ),
                gt_skeletons=gt.get("skeletons_file"),
                mask=mask,
                num_workers=int(ts.get("num_workers", 1)),
            )
            # json-safe keys
            sweep["thresholds"] = {
                str(k): v for k, v in sweep["thresholds"].items()
            }
            results["threshold_sweep"] = sweep

        if out_result:
            out_json = out_result
            if len(cfg_all) > 1 and volume is None:
                # several volumes share one -o path: suffix each so a
                # later volume does not overwrite an earlier one's JSON
                root, ext = os.path.splitext(out_result)
                out_json = f"{root}.{volume_name}{ext or '.json'}"
            os.makedirs(os.path.dirname(out_json) or ".", exist_ok=True)
        else:
            out_dir = cfg.get("out_result_dir", ".")
            os.makedirs(out_dir, exist_ok=True)
            out_json = os.path.join(out_dir, f"{volume_name}_results.json")
        with open(out_json, "w") as f:
            json.dump(results, f, indent=2)
        logger.info("wrote %s", out_json)
        all_results[volume_name] = results
    return all_results
