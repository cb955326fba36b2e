"""Segmentation workflow: TOML config -> in-memory ws, mws or cc
segmentation (the JAX package's ``workflows/segment.py``).

Per volume: read the affinities (``affs_dataset``), take the method's
defaults (``post/segment.py:METHOD_DEFAULTS``), ``[<volume>.<method>_params]``
and ``param_overrides`` (``key=value``), and write uint64 datasets under
``seg_dataset_prefix``, named as the JAX package names them:

- ws: one per threshold, ``<merge_function>--<threshold>``;
- mws: ``mws``, or with ``bias_sweep = [[short, long], ...]`` one per
  point, ``mws--a<short>_l<long>`` (each point's bias mapped per offset:
  ``short`` for the direct neighbours, ``long`` for the rest);
- cc: ``cc--<threshold>``.

With ``blockwise = true`` (or ``blockwise=True``) a volume is segmented
block by block (``post/blockwise_seg.py``) into
``dirname(seg_dataset_prefix)``: ws under ``segmentations_ws``, mws under
``segmentations_mws`` (``mws``, or one ``mws--a<adj>_l<lr>`` per point of
``global_bias_sweep``, all from one RAG), cc under ``segmentations_cc``.
``num_workers`` threads work on the blocks of one process; ``workers``
processes each take a stride-shard of the block grid, synchronised by a
SQLite ledger.
"""

from __future__ import annotations

import os
from ast import literal_eval
from typing import Optional

import numpy as np

from ..core.arrays import open_ds, prepare_ds
from ..core.geometry import Roi
from ..post.blockwise_seg import (
    _fmt_threshold,
    cc_pipeline_blockwise,
    mws_pipeline_blockwise,
    mws_sweep_label,
    waterz_pipeline_blockwise,
)
from ..post.segment import METHOD_DEFAULTS, cc_segmentation, mws_segmentation, waterz_segmentation
from ..utils import tomlio


def get_seg_config(cfg: dict, method: str, param_overrides=()) -> dict:
    params = dict(METHOD_DEFAULTS.get(method, {}))
    params.update(cfg.get(f"{method}_params", {}))
    for kv in param_overrides:
        k, v = kv.split("=", 1)
        try:
            params[k] = literal_eval(v)
        except (ValueError, SyntaxError):
            params[k] = v
    return params


def _write_seg(path: str, seg: np.ndarray, affs, roi: Roi) -> None:
    ds = prepare_ds(path, seg.shape, roi.offset, affs.voxel_size, np.uint64)
    ds[ds.roi] = seg


def run_segmentation(
    config_file: str,
    mode: str = "ws",
    volume: Optional[str] = None,
    param_overrides=(),
    roi_offset=None,
    roi_shape=None,
    blockwise: Optional[bool] = None,
    num_workers: Optional[int] = None,
    block_shape=None,
    context=None,
    require_params: bool = False,
    device=None,
) -> dict:
    """Segment every volume of the config by ``mode`` (ws, mws or cc);
    returns ``{volume: {key: dataset path}}`` (ws keys are thresholds).
    With ``require_params`` a volume without ``[<volume>.<mode>_params]``
    is skipped.  ``blockwise``, ``num_workers``, ``block_shape`` and
    ``context`` override the volume's config values.  ws's seeds run on
    ``device`` (every block's, when blockwise); mws and cc are host-only."""
    if mode not in METHOD_DEFAULTS:
        raise ValueError(f"unknown segmentation mode {mode!r}")
    if (roi_offset is None) != (roi_shape is None):
        raise ValueError("roi_offset and roi_shape must be given together")
    cfg_all = tomlio.load(config_file)
    cfg_all = cfg_all.get("segment", cfg_all)
    results = {}
    for volume_name, cfg in cfg_all.items():
        if volume is not None and volume_name != volume:
            continue
        if require_params and cfg.get(f"{mode}_params") is None:
            continue
        cfg = dict(cfg)
        for key, value in (
            ("blockwise", blockwise), ("num_workers", num_workers),
            ("block_shape", block_shape), ("context", context),
        ):
            if value is not None:
                cfg[key] = list(value) if key in ("block_shape", "context") else value
        params = get_seg_config(cfg, mode, param_overrides)
        roi = None
        if roi_offset is not None:
            roi = Roi(roi_offset, roi_shape)
        elif "roi_offset" in cfg:
            roi = Roi(cfg["roi_offset"], cfg["roi_shape"])
        # a local: volume N's value must not become volume N+1's override
        vol_blockwise = cfg.get("blockwise", False)
        if vol_blockwise:
            results[volume_name] = _segment_blockwise(cfg, mode, params, roi, device)
            continue
        affs = open_ds(cfg["affs_dataset"])
        a = affs.to_ndarray(roi) if roi else affs.to_ndarray()
        total = roi or affs.roi
        prefix = cfg["seg_dataset_prefix"]
        out = {}
        if mode == "ws":
            segs = waterz_segmentation(
                a,
                thresholds=params["thresholds"],
                merge_function=params["merge_function"],
                fragments_in_xy=params["fragments_in_xy"],
                min_seed_distance=params["min_seed_distance"],
                device=device,
            )
            for t, seg in segs.items():
                name = f"{prefix}/{params['merge_function']}--{_fmt_threshold(t)}"
                _write_seg(name, seg, affs, total)
                out[str(t)] = name
        elif mode == "mws":
            nbhd = params.get("neighborhood", params.get("aff_neighborhood"))
            sweep = params.get("bias_sweep")
            if sweep is not None:
                # biases per offset, not by position: a custom neighbourhood
                # may interleave direct neighbours and long-range offsets
                is_short = [max(abs(int(v)) for v in o) <= 1 for o in nbhd]
                points = [(s, lr, [s if sh else lr for sh in is_short]) for s, lr in sweep]
            else:
                points = [(None, None, params["bias"])]
            for short_b, long_b, bias_vec in points:
                seg = mws_segmentation(
                    a,
                    neighborhood=nbhd,
                    bias=bias_vec,
                    sigma=params.get("sigma"),
                    noise_eps=params.get("noise_eps"),
                    strides=params.get("strides"),
                    randomized_strides=params.get("randomized_strides", False),
                    remove_debris=params.get("remove_debris", 0),
                )
                key = "mws" if short_b is None else mws_sweep_label(short_b, long_b)
                name = f"{prefix}/{key}"
                _write_seg(name, seg, affs, total)
                out[key] = name
        else:
            seg = cc_segmentation(
                a, threshold=params.get("threshold", 0.5), remove_debris=params.get("remove_debris", 0)
            )
            name = f"{prefix}/cc--{_fmt_threshold(params.get('threshold', 0.5))}"
            _write_seg(name, seg, affs, total)
            out["cc"] = name
        results[volume_name] = out
    return results


def _segment_blockwise(cfg: dict, mode: str, params: dict, roi, device) -> dict:
    """One volume by the blockwise pipelines (the JAX package's blockwise
    branch): ``{key: dataset path}``, ws keyed by threshold strings."""
    out_container = os.path.dirname(cfg["seg_dataset_prefix"])
    common = dict(
        block_shape=tuple(cfg.get("block_shape", (32, 256, 256))),
        context_voxels=tuple(cfg.get("context", (2, 32, 32))),
        num_workers=cfg.get("num_workers", 8),
        roi=roi,
        # multi-process scale-out: crash-isolated subprocesses over
        # stride-shards of the block grid
        workers=int(params.pop("workers", cfg.get("workers", 1)) or 1),
        block_stride=int(params.pop("block_stride", 1)),
        block_offset=int(params.pop("block_offset", 0)),
        ledger=params.pop("ledger", cfg.get("ledger")),
        # RAG backend: a db config (-p "db={...}" or the volume's [db])
        # routes the RAG to PostgreSQL; by default a SQLite file
        db=params.pop("db", cfg.get("db")),
        device=device,
    )
    affs_path = cfg["affs_dataset"]
    if mode == "ws":
        segs = waterz_pipeline_blockwise(
            affs_path,
            out_container,
            thresholds=params.get("thresholds", [0.5]),
            merge_function=params.get("merge_function", "mean"),
            fragments_in_xy=params.get("fragments_in_xy", True),
            min_seed_distance=params.get("min_seed_distance", 10),
            filter_fragments=params.get("filter_fragments", 0.05),
            epsilon_agglomerate=params.get("epsilon_agglomerate", 0.0),
            replace_sections=params.get("replace_sections"),
            **common,
        )
        return {str(k): v for k, v in segs.items()}
    if mode == "mws":
        return mws_pipeline_blockwise(
            affs_path,
            out_container,
            neighborhood=params.get("neighborhood", params.get("aff_neighborhood")),
            bias=params["bias"],
            filter_fragments=params.get("filter_fragments", 0.1),
            sigma=params.get("sigma"),
            noise_eps=params.get("noise_eps"),
            strides=params.get("strides"),
            randomized_strides=params.get("randomized_strides", False),
            # (adj, lr) operating points swept over one RAG
            global_bias_sweep=params.get("global_bias_sweep"),
            **common,
        )
    return cc_pipeline_blockwise(
        affs_path,
        out_container,
        threshold=params.get("threshold", 0.5),
        remove_debris=params.get("remove_debris", 0),
        **common,
    )
