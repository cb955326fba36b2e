"""Self-supervised prediction-error maps: no ground truth required (the JAX
package's ``eval/errors.py``).

Recompute the model's affinities *from a candidate segmentation* and diff
them against the model's predictions: high disagreement marks probable
segmentation errors.  The error map and its thresholded mask are written
as Zarrs; summary stats feed the filter stage's choice of segmentation.

The block loop is the JAX package's: blocks tile the ROI (edge blocks
shift inward), each read grown by the neighbourhood's extent, the core
written back, and the stats counted over the part no earlier block
covered.  Per block, the ids are renumbered on the host (exact for any
uint64 ids, 0 stays background, so no uint64 reaches the device), and the
affinities, squared difference, channel mean and mask run on ``device``
in fp32.  Ids at or above 2^31 therefore score as themselves; the JAX
package casts them to int32 under jit.

LSD targets are not ported, so ``compute_lsd_errors`` raises.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..core.arrays import Array, prepare_ds
from ..core.geometry import Coordinate
from ..ops.affinities import seg_to_affs
from ..predict.scan import tile_rois
from ..train.sampler import renumber


def compute_lsd_errors(*args, **kwargs) -> Dict:
    raise NotImplementedError(
        "LSD error maps need LSD targets, which are not ported yet (ROADMAP A2)"
    )


def upload_block(seg_block: np.ndarray, pred: np.ndarray, device) -> tuple:
    """A block's renumbered ids (int32) and predictions on ``device``;
    uint8 predictions travel as bytes and become ``/255`` fp32 there."""
    seg_t = torch.from_numpy(seg_block).to(device)
    pred_t = torch.from_numpy(pred).to(device)
    if pred_t.dtype.is_floating_point:
        return seg_t, pred_t.to(torch.float32)
    return seg_t, pred_t.to(torch.float32) / 255.0


def block_error(seg_t, pred_t, neighborhood, thresholds=(0.1, 1.0)) -> tuple:
    """``sum((seg_to_affs(seg) - pred)^2, 0) / n_ch`` and the uint8 mask
    ``t0 < err <= t1``, on the tensors' device."""
    affs = seg_to_affs(seg_t, neighborhood)
    err = torch.sum((affs - pred_t) ** 2, dim=0) / len(neighborhood)
    mask = (err > thresholds[0]) & (err <= thresholds[1])
    return err, mask.to(torch.uint8)


def compute_aff_errors(
    seg: Array,
    pred_affs: Array,
    neighborhood: Sequence[Sequence[int]],
    out_container: str,
    voxel_size=None,
    block_shape=(16, 128, 128),
    thresholds=(0.1, 1.0),
    dataset_prefix: str = "aff_error",
    device=None,
) -> Dict:
    """Scan the volume: recompute affinities from ``seg``, diff vs
    ``pred_affs`` summed over channels, on ``device`` (``cuda`` unless
    ``"cpu"`` is asked for)."""
    dev = resolve_device(device)
    vs = Coordinate(voxel_size) if voxel_size is not None else seg.voxel_size
    roi = seg.roi.intersect(pred_affs.roi)
    pad = Coordinate(
        max(abs(o[d]) for o in neighborhood) * vs[d]
        for d in range(len(vs))
    )

    err_ds = prepare_ds(
        f"{out_container}/{dataset_prefix}_map",
        shape=tuple(Coordinate(roi.shape) / vs),
        offset=roi.offset,
        voxel_size=vs,
        dtype=np.float32,
    )
    mask_ds = prepare_ds(
        f"{out_container}/{dataset_prefix}_mask",
        shape=tuple(Coordinate(roi.shape) / vs),
        offset=roi.offset,
        voxel_size=vs,
        dtype=np.uint8,
    )
    # blocks never larger than the ROI: tile_rois requires it
    block_size = Coordinate(
        min(b * v, s) for b, v, s in zip(block_shape, vs, roi.shape)
    )
    n_ch = len(neighborhood)

    total = 0
    nonzero = 0
    for wroi, fresh in tile_rois(roi, block_size, with_fresh=True):
        rroi = wroi.grow(pad, pad)
        seg_block = renumber(seg.to_ndarray(rroi))
        pred = pred_affs.to_ndarray(rroi)[:n_ch]
        seg_t, pred_t = upload_block(seg_block, pred, dev)
        err_t, mask_t = block_error(seg_t, pred_t, neighborhood, thresholds)
        core = tuple(
            slice(int(a), int(a + s))
            for a, s in zip(
                (wroi.begin - rroi.begin) / vs,
                Coordinate(wroi.shape) / vs,
            )
        )
        err_ds[wroi] = err_t[core].cpu().numpy()
        m = mask_t[core].cpu().numpy()
        mask_ds[wroi] = m
        fr = tuple(
            slice(int(a), int(a + s))
            for a, s in zip(
                (fresh.begin - wroi.begin) / vs,
                Coordinate(fresh.shape) / vs,
            )
        )
        total += m[fr].size
        nonzero += int(m[fr].sum())

    return {
        "error_map": err_ds.path,
        "error_mask": mask_ds.path,
        "nonzero_ratio": nonzero / max(total, 1),
        "total_voxels": total,
        "nonzero_voxels": nonzero,
    }
