"""Self-supervised prediction-error maps: no ground truth required (the JAX
package's ``eval/errors.py``).

Recompute the model's targets (affinities or LSDs) *from a candidate
segmentation* and diff them against the model's predictions: high
disagreement marks probable segmentation errors.  The error map and its
thresholded mask are written as Zarrs; summary stats feed the filter
stage's choice of segmentation.

The block loop is the JAX package's: blocks tile the ROI (edge blocks
shift inward), each read grown by the neighbourhood's extent (by 3 sigma,
snapped up to the voxel grid, for LSDs), the core written back, and the
stats counted over the part no earlier block covered.  Per block, the ids
are renumbered on the host (exact for any uint64 ids, 0 stays background,
so no uint64 reaches the device), and the targets, squared difference,
channel mean and mask run on ``device`` in fp32.  Ids at or above 2^31
therefore score as themselves in the affinity map; the JAX package casts
them to int32 under jit there.

LSDs are computed in id chunks of ``MAX_LABELS - 1``: each voxel's LSDs
are nonzero only in the chunk holding its label, so the chunks' sum is
the unclamped result.  Each chunk's one-hot holds only as many channels as
its largest id needs (the JAX package always holds ``MAX_LABELS``; the
extra channels are empty and change nothing).
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..core.arrays import Array, prepare_ds
from ..core.geometry import Coordinate
from ..ops.affinities import seg_to_affs
from ..ops.lsd import lsd_descriptors_downsampled
from ..predict.scan import tile_rois
from ..train.sampler import renumber


MAX_LABELS = 256


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


def block_lsds(seg_t, n_ids: int, sigma, voxel_size, downsample: int):
    """The LSDs of a renumbered block (ids ``0..n_ids``), summed over id
    chunks of ``MAX_LABELS - 1``, on the tensor's device."""
    lsds = None
    for lo in range(0, max(n_ids, 1), MAX_LABELS - 1):
        seg_c = seg_t.to(torch.int64) - lo
        seg_c = torch.where((seg_c > 0) & (seg_c < MAX_LABELS), seg_c, 0)
        part = lsd_descriptors_downsampled(
            seg_c, sigma=sigma, voxel_size=voxel_size, downsample=downsample,
            max_labels=min(MAX_LABELS, n_ids - lo + 1),
        )
        lsds = part if lsds is None else lsds + part
    return lsds


def block_lsd_error(seg_t, n_ids: int, pred_t, sigma, voxel_size, downsample: int,
                    thresholds=(0.1, 1.0)) -> tuple:
    """``sum((lsds(seg) - pred)^2, 0) / n_ch`` and the uint8 mask ``t0 <
    err <= t1``, on the tensors' device."""
    lsds = block_lsds(seg_t, n_ids, sigma, voxel_size, downsample)
    err = torch.sum((lsds - pred_t) ** 2, dim=0) / pred_t.shape[0]
    mask = (err > thresholds[0]) & (err <= thresholds[1])
    return err, mask.to(torch.uint8)


def download_block(err_t, mask_t, core) -> tuple:
    """The core of a block's map and mask as host arrays."""
    return err_t[core].cpu().numpy(), mask_t[core].cpu().numpy()


def _scan(seg: Array, pred: Array, out_container: str, vs, pad, block_shape, dataset_prefix: str,
          error_fn) -> Dict:
    """The block loop shared by both maps: ``error_fn(renumbered block,
    its largest id, predictions block)`` gives each block's ``(err, mask)``
    tensors over the read grown by ``pad``; their cores are written and the
    fresh parts counted."""
    roi = seg.roi.intersect(pred.roi)
    shape = tuple(Coordinate(roi.shape) / vs)
    err_ds = prepare_ds(f"{out_container}/{dataset_prefix}_map", shape=shape, offset=roi.offset,
                        voxel_size=vs, dtype=np.float32)
    mask_ds = prepare_ds(f"{out_container}/{dataset_prefix}_mask", shape=shape, offset=roi.offset,
                         voxel_size=vs, dtype=np.uint8)
    # blocks never larger than the ROI: tile_rois requires it
    block_size = Coordinate(min(b * v, s) for b, v, s in zip(block_shape, vs, roi.shape))

    total = 0
    nonzero = 0
    for wroi, fresh in tile_rois(roi, block_size, with_fresh=True):
        rroi = wroi.grow(pad, pad)
        seg_block = renumber(seg.to_ndarray(rroi))
        err_t, mask_t = error_fn(seg_block, int(seg_block.max()), pred.to_ndarray(rroi))
        core = tuple(
            slice(int(a), int(a + s))
            for a, s in zip((wroi.begin - rroi.begin) / vs, Coordinate(wroi.shape) / vs)
        )
        err, m = download_block(err_t, mask_t, core)
        err_ds[wroi] = err
        mask_ds[wroi] = m
        # stats over the part no earlier block counted: inward-shifted edge
        # blocks overlap their neighbours
        fr = tuple(
            slice(int(a), int(a + s))
            for a, s in zip((fresh.begin - wroi.begin) / vs, Coordinate(fresh.shape) / vs)
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
    pad = Coordinate(max(abs(o[d]) for o in neighborhood) * vs[d] for d in range(len(vs)))
    n_ch = len(neighborhood)

    def error_fn(seg_block, n_ids, pred):
        seg_t, pred_t = upload_block(seg_block, pred[:n_ch], dev)
        return block_error(seg_t, pred_t, neighborhood, thresholds)

    return _scan(seg, pred_affs, out_container, vs, pad, block_shape, dataset_prefix, error_fn)


def lsd_context(sigma3, voxel_size) -> Coordinate:
    """The LSD scan's read margin: 3 sigma, snapped up to the voxel grid."""
    return Coordinate(((int(3 * s) + v - 1) // v) * v for s, v in zip(sigma3, voxel_size))


def compute_lsd_errors(
    seg: Array,
    pred_lsds: Array,
    sigma,
    out_container: str,
    voxel_size=None,
    downsample: int = 2,
    block_shape=(16, 128, 128),
    thresholds=(0.1, 1.0),
    dataset_prefix: str = "lsd_error",
    device=None,
) -> Dict:
    """Scan the volume: recompute LSDs from ``seg``, diff vs ``pred_lsds``
    summed over channels, on ``device`` (``cuda`` unless ``"cpu"`` is
    asked for)."""
    dev = resolve_device(device)
    vs = Coordinate(voxel_size) if voxel_size is not None else seg.voxel_size
    sigma3 = tuple(sigma) if not np.isscalar(sigma) else (sigma,) * 3
    pad = lsd_context(sigma3, vs)

    def error_fn(seg_block, n_ids, pred):
        seg_t, pred_t = upload_block(seg_block, pred, dev)
        return block_lsd_error(seg_t, n_ids, pred_t, sigma3, tuple(vs), downsample, thresholds)

    return _scan(seg, pred_lsds, out_container, vs, pad, block_shape, dataset_prefix, error_fn)
