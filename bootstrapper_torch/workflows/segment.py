"""Segmentation workflow: TOML config -> in-memory ws segmentation (the
JAX package's ``workflows/segment.py``, ws mode).

Per volume: read the affinities (``affs_dataset``), run
``waterz_segmentation`` with the ws defaults, ``[<volume>.ws_params]``
and ``param_overrides`` (``key=value``), and write one uint64 dataset per
threshold as ``<seg_dataset_prefix>/<merge_function>--<threshold>``.
Blockwise runs and the mws and cc modes are not ported yet.
"""

from __future__ import annotations

from ast import literal_eval
from typing import Optional

import numpy as np

from ..core.arrays import open_ds, prepare_ds
from ..core.geometry import Roi
from ..post.segment import WS_DEFAULTS, waterz_segmentation
from ..utils import tomlio


def _fmt_threshold(t: float) -> str:
    return f"{t:.3f}".rstrip("0").rstrip(".").replace(".", "_")


def get_seg_config(cfg: dict, param_overrides=()) -> dict:
    params = dict(WS_DEFAULTS)
    params.update(cfg.get("ws_params", {}))
    for kv in param_overrides:
        k, v = kv.split("=", 1)
        try:
            params[k] = literal_eval(v)
        except (ValueError, SyntaxError):
            params[k] = v
    return params


def run_segmentation(
    config_file: str,
    mode: str = "ws",
    volume: Optional[str] = None,
    param_overrides=(),
    roi_offset=None,
    roi_shape=None,
    device=None,
) -> dict:
    """Segment every volume of the config; returns ``{volume: {threshold:
    dataset path}}``.  Seeds run on ``device``."""
    if mode != "ws":
        raise NotImplementedError(f"segmentation mode {mode!r} is not ported yet")
    if (roi_offset is None) != (roi_shape is None):
        raise ValueError("roi_offset and roi_shape must be given together")
    cfg_all = tomlio.load(config_file)
    cfg_all = cfg_all.get("segment", cfg_all)
    results = {}
    for volume_name, cfg in cfg_all.items():
        if volume is not None and volume_name != volume:
            continue
        if cfg.get("blockwise", False):
            raise NotImplementedError("blockwise segmentation is not ported yet")
        params = get_seg_config(cfg, param_overrides)
        roi = None
        if roi_offset is not None:
            roi = Roi(roi_offset, roi_shape)
        elif "roi_offset" in cfg:
            roi = Roi(cfg["roi_offset"], cfg["roi_shape"])
        affs = open_ds(cfg["affs_dataset"])
        a = affs.to_ndarray(roi) if roi else affs.to_ndarray()
        total = roi or affs.roi
        segs = waterz_segmentation(
            a,
            thresholds=params["thresholds"],
            merge_function=params["merge_function"],
            fragments_in_xy=params["fragments_in_xy"],
            min_seed_distance=params["min_seed_distance"],
            device=device,
        )
        out = {}
        for t, seg in segs.items():
            name = (
                f"{cfg['seg_dataset_prefix']}/"
                f"{params['merge_function']}--{_fmt_threshold(t)}"
            )
            ds = prepare_ds(name, seg.shape, total.offset, affs.voxel_size, np.uint64)
            ds[ds.roi] = seg
            out[str(t)] = name
        results[volume_name] = out
    return results
