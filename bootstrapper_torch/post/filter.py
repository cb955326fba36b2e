"""Segmentation filtering -> pseudo-ground-truth for the next round (a
copy of the JAX package's ``post/filter.py``).

Capability parity with the reference's filter stage (reference
``bootstrapper/post/blockwise/filter_segmentation.py:12-274``,
``post/size_filter.py``, ``post/outlier_filter.py``): remove dust,
size outliers (4-sigma), fragments spanning too few z-sections, and
ids with poor inter-slice overlap; then write filtered labels plus an
object mask (optionally multiplied by an error mask and z-eroded) —
the pseudo-GT inputs of round N+1.

The global id statistics are vectorised with dense relabel + bincounts
(the reference loops per id); the masking pass runs on our blockwise
engine.
"""

from __future__ import annotations

import logging
from typing import Optional, Sequence

import numpy as np
from scipy import ndimage

from .. import native
from ..core.arrays import open_ds, prepare_ds
from ..core.blockwise import BlockwiseTask, run_blockwise_or_raise
from ..core.geometry import Coordinate, Roi

logger = logging.getLogger(__name__)


def compute_ids_to_remove(
    labels: np.ndarray,
    dust_filter: int = 0,
    remove_outliers: bool = False,
    remove_z_fragments: int = 1,
    overlap_filter: float = 0.0,
) -> np.ndarray:
    """Global filter: ids failing any enabled criterion."""
    all_ids, inverse = np.unique(labels, return_inverse=True)
    inverse = inverse.reshape(labels.shape)
    counts = np.bincount(inverse.ravel(), minlength=len(all_ids))
    nonzero = all_ids != 0
    keep = nonzero.copy()

    if dust_filter > 0:
        keep &= counts >= dust_filter

    if remove_outliers:
        surv = counts[keep]
        if len(surv):
            mean, std = surv.mean(), surv.std()
            keep &= np.abs(counts - mean) <= 4 * std
            keep &= nonzero

    if remove_z_fragments > 1:
        # number of z-slices each id appears in
        z_counts = np.zeros(len(all_ids), np.int64)
        for z in range(labels.shape[0]):
            z_counts[np.unique(inverse[z])] += 1
        keep &= z_counts >= remove_z_fragments

    if overlap_filter > 0.0:
        # Exact reference semantics (``post/blockwise/filter_
        # segmentation.py:96-121``): an id must meet the overlap ratio
        # in EVERY slice pair where it appears in the later slice. An
        # id first appearing at z>0 has ratio 0 at that pair and is
        # removed — by design: the filter keeps only segments that are
        # z-continuous from their start, treating pop-in fragments as
        # errors. (Ids present at z=0 have no earlier pair to fail.)
        K = len(all_ids)
        ok = np.ones(K, bool)
        for z in range(1, labels.shape[0]):
            area = np.bincount(inverse[z].ravel(), minlength=K)
            same = inverse[z] == inverse[z - 1]
            inter = np.bincount(inverse[z][same].ravel(), minlength=K)
            present = area > 0
            ratio = np.divide(
                inter, area, out=np.zeros(K, float), where=present
            )
            ok &= ~present | (ratio >= overlap_filter)
        keep &= ok

    return all_ids[nonzero & ~keep]


def filter_segmentation_blockwise(
    seg_path: str,
    out_labels_path: str,
    out_mask_path: str,
    error_mask_path: Optional[str] = None,
    dust_filter: int = 0,
    remove_outliers: bool = False,
    remove_z_fragments: int = 1,
    overlap_filter: float = 0.0,
    exclude_ids: Optional[Sequence[int]] = None,
    erode_out_mask: bool = False,
    block_shape=(16, 256, 256),
    num_workers: int = 8,
    roi: Optional[Roi] = None,
) -> dict:
    seg = open_ds(seg_path)
    vs = seg.voxel_size
    total = roi or seg.roi
    vox_shape = tuple(Coordinate(total.shape) / vs)

    # global pass (whole-volume stats; memory-bound like the reference)
    labels = seg.to_ndarray(total)
    to_remove = compute_ids_to_remove(
        labels, dust_filter, remove_outliers, remove_z_fragments,
        overlap_filter,
    )
    if exclude_ids:
        to_remove = np.union1d(to_remove, np.asarray(exclude_ids, np.uint64))
    logger.info("filter: removing %d ids", len(to_remove))
    del labels

    out_labels = prepare_ds(
        out_labels_path, vox_shape, total.offset, vs, np.uint64,
        chunk_shape=tuple(min(b, s) for b, s in zip(block_shape, vox_shape)),
    )
    out_mask = prepare_ds(
        out_mask_path, vox_shape, total.offset, vs, np.uint8,
        chunk_shape=tuple(min(b, s) for b, s in zip(block_shape, vox_shape)),
    )
    error_mask = open_ds(error_mask_path) if error_mask_path else None

    remove_arr = np.asarray(to_remove, np.uint64)
    zeros = np.zeros(len(remove_arr), np.uint64)
    context = Coordinate((vs[0], vs[1], vs[2]))  # 1 voxel for erosion

    def process(block):
        rroi = block.read_roi
        lab = seg.to_ndarray(rroi)
        if len(remove_arr):
            lab = native.replace_values(lab, remove_arr, zeros)
        mask = lab > 0
        if error_mask is not None:
            err = error_mask.to_ndarray(rroi)
            mask &= ~(err > 0)
        if erode_out_mask:
            # erode in z only: 3-tall cross structuring element
            struct = np.zeros((3, 3, 3), bool)
            struct[:, 1, 1] = True
            mask = ndimage.binary_erosion(mask, struct)
        wroi = block.write_roi.intersect(total)
        lo = (wroi.begin - rroi.begin) / vs
        hi = lo + wroi.shape / vs
        core = tuple(slice(int(a), int(b)) for a, b in zip(lo, hi))
        out_labels[wroi] = lab[core]
        out_mask[wroi] = mask[core].astype(np.uint8)

    task = BlockwiseTask(
        name="filter_segmentation",
        total_roi=total,
        write_size=Coordinate(block_shape) * vs,
        context_neg=context,
        context_pos=context,
        process=process,
        read_write_conflict=False,
        num_workers=num_workers,
    )
    run_blockwise_or_raise(task)
    return {
        "labels": out_labels_path,
        "mask": out_mask_path,
        "removed_ids": len(to_remove),
    }


# -- standalone in-memory filters (bs utils capability) ---------------------


def size_filter(seg: np.ndarray, min_size: int, relabel_cc: bool = True):
    """Remove segments smaller than ``min_size`` voxels, then relabel
    connected components (``post/size_filter.py`` capability)."""
    ids, counts = np.unique(seg, return_counts=True)
    kill = ids[(counts < min_size) & (ids != 0)]
    out = native.replace_values(
        np.asarray(seg, np.uint64), kill, np.zeros(len(kill), np.uint64)
    )
    if relabel_cc:
        out, _ = ndimage.label(out > 0)
        out = out.astype(np.uint64)
    return out


def outlier_filter(seg: np.ndarray, sigma: float = 4.0, relabel_cc: bool = True):
    """Remove segments whose size deviates more than ``sigma`` stds from
    the mean (``post/outlier_filter.py`` capability)."""
    ids, counts = np.unique(seg, return_counts=True)
    nz = ids != 0
    if nz.sum() == 0:
        return np.asarray(seg, np.uint64)
    mean, std = counts[nz].mean(), counts[nz].std()
    kill = ids[nz & (np.abs(counts - mean) > sigma * std)]
    out = native.replace_values(
        np.asarray(seg, np.uint64), kill, np.zeros(len(kill), np.uint64)
    )
    if relabel_cc:
        out, _ = ndimage.label(out > 0)
        out = out.astype(np.uint64)
    return out
