"""Filter workflow: pick the best segmentation, emit pseudo-GT
(a copy of the JAX package's ``workflows/filter.py``; all host work).

Equivalent of the reference filter script (reference
``bootstrapper/filter.py:20-193``): choose the best segmentation from
the evaluation JSON (min ``voi_sum``, max ``nerl``, or max error-mask
``nonzero_ratio`` — ``filter.py:26-52``), then run the blockwise filter
to produce the next round's labels + mask.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Optional

from ..core.geometry import Roi
from ..post.filter import filter_segmentation_blockwise
from ..utils import tomlio

logger = logging.getLogger(__name__)


def get_best_seg_from_eval(eval_json: str) -> tuple:
    """(best segmentation path, its error-mask path or None)."""
    with open(eval_json) as f:
        results = json.load(f)
    results = {
        k: v
        for k, v in results.items()
        if isinstance(v, dict)
        and ({"voi", "skeletons", "pred_errors"} & set(v))
    }
    if not results:
        raise ValueError(f"no scored segmentations in {eval_json}")

    def score(entry):
        if "voi" in entry:
            return ("voi", -(entry["voi"]["voi_sum"]))  # lower better
        if "skeletons" in entry:
            return ("nerl", entry["skeletons"]["nerl"])
        if "pred_errors" in entry:
            # lower error ratio is better
            return ("err", -entry["pred_errors"]["nonzero_ratio"])
        return ("none", 0.0)

    best = max(results.items(), key=lambda kv: score(kv[1])[1])
    logger.info("best segmentation: %s (%s)", best[0], score(best[1]))
    err_mask = best[1].get("pred_errors", {}).get("error_mask")
    return best[0], err_mask


def run_filter(
    config_file: str,
    volume: Optional[str] = None,
    param_overrides=(),
    roi_offset=None,
    roi_shape=None,
    num_workers: Optional[int] = None,
    block_shape=None,
) -> dict:
    """CLI kwargs override per-volume config values (reference
    ``filter.py:155-193`` option surface: -ro/-rs/-n/-bs/-p)."""
    from ast import literal_eval

    cfg_all = tomlio.load(config_file)
    cfg_all = cfg_all.get("filter", cfg_all)
    if (roi_offset is None) != (roi_shape is None):
        raise ValueError(
            "--roi-offset and --roi-shape must be given together"
        )
    out = {}
    for volume_name, cfg in cfg_all.items():
        if volume is not None and volume_name != volume:
            continue
        cfg = dict(cfg)
        if roi_offset is not None:
            cfg["roi_offset"] = list(roi_offset)
            cfg["roi_shape"] = list(roi_shape)
        if num_workers is not None:
            cfg["num_workers"] = num_workers
        if block_shape is not None:
            cfg["block_shape"] = list(block_shape)
        for kv in param_overrides:
            k, v = kv.split("=", 1)
            try:
                cfg[k] = literal_eval(v)
            except (ValueError, SyntaxError):
                cfg[k] = v
        if ("roi_offset" in cfg) != ("roi_shape" in cfg):
            raise ValueError(
                "roi_offset and roi_shape must be given together "
                f"(volume {volume_name!r})"
            )
        err_mask = None
        if "seg_dataset" in cfg:
            seg_path = cfg["seg_dataset"]
        else:
            eval_json = os.path.join(
                cfg["eval_dir"], f"{volume_name}_results.json"
            )
            seg_path, err_mask = get_best_seg_from_eval(eval_json)
        res = filter_segmentation_blockwise(
            seg_path,
            cfg["out_seg_dataset_prefix"],
            cfg["out_mask_dataset_prefix"],
            error_mask_path=cfg.get("error_mask_dataset", err_mask),
            dust_filter=cfg.get("dust_filter", 500),
            remove_outliers=cfg.get("remove_outliers", True),
            remove_z_fragments=cfg.get("remove_z_fragments", 10),
            overlap_filter=cfg.get("overlap_filter", 0.0),
            erode_out_mask=cfg.get("erode_out_mask", False),
            exclude_ids=cfg.get("exclude_ids"),
            block_shape=tuple(cfg.get("block_shape", (16, 256, 256))),
            num_workers=cfg.get("num_workers", 8),
            roi=(
                Roi(cfg["roi_offset"], cfg["roi_shape"])
                if "roi_offset" in cfg
                else None
            ),
        )
        res["source_segmentation"] = seg_path
        out[volume_name] = res
    return out
