"""Interactive proofreading: point-prompted segments, merge / unmerge /
omit / filter, written back to Zarr as sparse ground truth (the JAX
package's ``proofread.py``).

A point prompt grows a segment by seeded watershed on the model's
affinities (per section or in 3D), on the host; with a SAM checkpoint
(``sam_checkpoint`` or ``BS_SAM_CHECKPOINT`` naming a file) it runs SAM's
mask-from-point on the prompted section instead, on ``device``.  The
session is a plain Python API; ``proofread_ui.launch_viewer`` drives it
from neuroglancer where that package is importable, and the command line's
``proofread`` from a script of commands.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Optional, Sequence

import numpy as np
from scipy import ndimage

from . import native, resolve_device
from .core.arrays import Array, prepare_ds
from .core.geometry import Coordinate, Roi

logger = logging.getLogger(__name__)


class ProofreadSession:
    """Point-prompted annotation over a raw volume and, optionally, its
    affinity predictions.  ``device`` (``cuda`` unless ``"cpu"`` is asked
    for) is where SAM runs."""

    def __init__(
        self,
        raw: Array,
        affs: Optional[Array] = None,
        boundary_threshold: float = 0.5,
        sam_checkpoint: Optional[str] = None,
        device=None,
    ):
        self.raw = raw
        self.affs = affs
        self.boundary_threshold = boundary_threshold
        self.device = resolve_device(device)
        self.labels = np.zeros(raw.spatial_shape, np.uint64)
        self.next_id = 1
        self.omitted: set = set()
        self._sam = None
        self._sam_section = None
        ckpt = sam_checkpoint or os.environ.get("BS_SAM_CHECKPOINT")
        if ckpt and os.path.exists(ckpt):
            from .models.sam import SamPredictor, load_sam

            model, cfg = load_sam(ckpt, self.device)
            self._sam = SamPredictor(model, cfg, device=self.device)
            logger.info("SAM checkpoint loaded from %s", ckpt)

    # -- prompting ---------------------------------------------------------

    def _boundary_landscape(self, roi: Roi):
        if self.affs is not None:
            a = self.affs.to_ndarray(roi)
            if np.issubdtype(a.dtype, np.integer):
                a = a.astype(np.float32) / 255.0
            else:
                a = a.astype(np.float32)
            # the lateral (y/x) affinities' mean: the z channel stays high
            # across section boundaries and would wash them out
            return 0.5 * (a[-1] + a[-2])
        # no affinities: intensity gradients of raw
        r = self.raw.to_ndarray(roi).astype(np.float32)
        r /= max(r.max(), 1)
        gy = ndimage.sobel(r, axis=-2)
        gx = ndimage.sobel(r, axis=-1)
        return 1.0 - np.clip(np.hypot(gy, gx), 0, 1)

    def segment_from_point(self, point, radius: int = 64, two_d: bool = False) -> int:
        """Grow a new segment from a world-unit point prompt; returns its id
        (0 where the prompt lies on a boundary).

        The prompt seeds a watershed on the boundary landscape within
        ``radius`` voxels in y/x (``radius // 8`` in z, or one section with
        ``two_d``); growth stops where the mean lateral affinity falls to the
        threshold.  With SAM loaded, SAM's mask-from-point on the section."""
        vs = self.raw.voxel_size
        p_vox = (Coordinate(point) - self.raw.offset) / vs
        if self._sam is not None:
            return self._sam_segment_from_point(p_vox)
        z_r = 0 if two_d else radius // 8
        shape = self.raw.spatial_shape
        lo = Coordinate(max(0, p_vox[0] - z_r), max(0, p_vox[1] - radius), max(0, p_vox[2] - radius))
        hi = Coordinate(
            min(shape[0], p_vox[0] + z_r + 1), min(shape[1], p_vox[1] + radius), min(shape[2], p_vox[2] + radius)
        )
        landscape = self._boundary_landscape(Roi(self.raw.offset + lo * vs, (hi - lo) * vs))
        mask = landscape > self.boundary_threshold
        local = tuple(p_vox - lo)
        if not mask[local]:
            logger.warning("prompt lies on a boundary; nothing grown")
            return 0
        seeds = np.zeros(landscape.shape, np.uint64)
        seeds[local] = self.next_id
        grown = native.watershed_seeded(1.0 - landscape, seeds, mask.astype(np.uint8))
        sl = tuple(slice(a, b) for a, b in zip(lo, hi))
        target = self.labels[sl]
        target[(grown == self.next_id) & (target == 0)] = self.next_id
        seg_id = self.next_id
        self.next_id += 1
        return seg_id

    def _sam_segment_from_point(self, p_vox) -> int:
        """SAM's mask-from-point on the prompted z section: the section is
        embedded once, each later click on it runs the decoder only.  Of the
        three multimask outputs the one of highest predicted IOU is taken;
        the single-mask output (token 0) has an IOU head of its own scale
        and does not compete."""
        z = int(p_vox[0])
        if self._sam_section != z:
            vs = self.raw.voxel_size
            section = self.raw.to_ndarray(
                Roi(self.raw.offset + Coordinate((z, 0, 0)) * vs, Coordinate((1, *self.raw.spatial_shape[1:])) * vs)
            )[0]
            self._sam.set_image(np.asarray(section))
            self._sam_section = z
        masks, iou = self._sam.predict([[int(p_vox[2]), int(p_vox[1])]], [1])  # (x, y)
        best = masks[1:][int(np.argmax(iou[1:]))]
        target = self.labels[z]
        target[best & (target == 0)] = self.next_id
        seg_id = self.next_id
        self.next_id += 1
        return seg_id

    # -- edits -------------------------------------------------------------

    def merge(self, ids: Sequence[int]) -> int:
        ids = [int(i) for i in ids if i != 0]
        keep = ids[0]
        rest = np.asarray(ids[1:], np.uint64)
        self.labels = native.replace_values(self.labels, rest, np.full(len(rest), keep, np.uint64))
        return keep

    def unmerge(self, seg_id: int) -> list:
        """Split a segment into its connected components."""
        cc, n = ndimage.label(self.labels == seg_id)
        new_ids = []
        for c in range(1, n + 1):
            self.labels[cc == c] = self.next_id
            new_ids.append(self.next_id)
            self.next_id += 1
        return new_ids

    def omit(self, seg_id: int):
        """Mark a segment as not ground truth (out of the mask)."""
        self.omitted.add(int(seg_id))

    def delete(self, seg_id: int):
        self.labels[self.labels == seg_id] = 0

    def filter_small(self, min_size: int):
        ids, counts = np.unique(self.labels, return_counts=True)
        kill = ids[(counts < min_size) & (ids != 0)]
        if len(kill):
            self.labels = native.replace_values(self.labels, kill, np.zeros(len(kill), np.uint64))
        return len(kill)

    # -- output ------------------------------------------------------------

    def write(self, container: str, labels_name="proofread/labels", mask_name="proofread/mask") -> Dict[str, str]:
        """Write the labels and a mask Zarr (omitted ids out of the mask)."""
        vs = self.raw.voxel_size
        labels_ds = prepare_ds(f"{container}/{labels_name}", self.labels.shape, self.raw.offset, vs, np.uint64)
        labels_ds[labels_ds.roi] = self.labels
        mask = (self.labels > 0).astype(np.uint8)
        for oid in self.omitted:
            mask[self.labels == oid] = 0
        mask_ds = prepare_ds(f"{container}/{mask_name}", mask.shape, self.raw.offset, vs, np.uint8)
        mask_ds[mask_ds.roi] = mask
        return {"labels": f"{container}/{labels_name}", "mask": f"{container}/{mask_name}"}
