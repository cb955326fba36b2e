"""Volume intake: bring user data (Zarr/TIFF/stacks) into round-ready form
(the JAX package's ``data/volumes.py`` over the port's arrays).

Capability parity with the reference's volume preparation (reference
``bootstrapper/data/volumes.py:9-242``): normalise legacy attrs
(``resolution`` -> ``voxel_size``), convert non-Zarr inputs, optional
bounding-box crop, optional raw/object mask creation — producing the
``volumes`` dict entries the config factory consumes.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Optional

from ..core.arrays import Array, _normalize_attrs, _read_attrs, open_ds
from .tools import bbox_crop, convert_to_zarr, make_obj_mask, make_raw_mask

logger = logging.getLogger(__name__)


def process_zarr(path: str) -> Array:
    """Open a Zarr dataset, normalising legacy attributes in place."""
    attrs = _read_attrs(path)
    normalized = _normalize_attrs(attrs, ndim=3)
    if normalized != attrs:
        with open(os.path.join(path, ".zattrs"), "w") as f:
            json.dump(normalized, f, indent=2)
        logger.info("normalised attrs of %s", path)
    return open_ds(path)


def process_non_zarr(
    path: str, out_path: str, voxel_size=(1, 1, 1), dtype=None
) -> Array:
    """TIFF stack / image dir / npy -> Zarr."""
    return convert_to_zarr(path, out_path, voxel_size=voxel_size, dtype=dtype)


def process_dataset(
    path: str,
    out_container: str,
    name: str,
    voxel_size=(1, 1, 1),
    crop_to_labels: bool = False,
    dtype=None,
) -> str:
    """Ingest one dataset (any supported format) into the container."""
    if os.path.isdir(path) and os.path.exists(
        os.path.join(path, ".zarray")
    ):
        arr = process_zarr(path)
        out_path = path
    else:
        out_path = os.path.join(out_container, name)
        arr = process_non_zarr(path, out_path, voxel_size, dtype)
    if crop_to_labels:
        cropped = os.path.join(out_container, f"{name}_cropped")
        bbox_crop(out_path, cropped)
        out_path = cropped
    return out_path


def prepare_volume(
    name: str,
    raw_path: str,
    labels_path: Optional[str] = None,
    labels_mask_path: Optional[str] = None,
    out_container: Optional[str] = None,
    voxel_size=(1, 1, 1),
    make_raw_mask_ds: bool = False,
    make_labels_mask_ds: bool = False,
) -> dict:
    """Build one ``volumes`` entry for the config factory, converting
    and masking as requested."""
    out_container = out_container or os.path.dirname(raw_path.rstrip("/"))
    raw_ds = process_dataset(
        raw_path, out_container, "raw", voxel_size, dtype="uint8"
    )
    raw = open_ds(raw_ds)
    volume = {
        "raw_dataset": raw_ds,
        "voxel_size": list(raw.voxel_size),
        "output_container": out_container,
    }
    if labels_path:
        labels_ds = process_dataset(
            labels_path, out_container, "labels", voxel_size
        )
        volume["labels_dataset"] = labels_ds
        if make_labels_mask_ds and not labels_mask_path:
            labels_mask_path = os.path.join(out_container, "labels_mask")
            make_obj_mask(labels_ds, labels_mask_path)
    if labels_mask_path:
        volume["labels_mask_dataset"] = labels_mask_path
    if make_raw_mask_ds:
        mask_path = os.path.join(out_container, "raw_mask")
        make_raw_mask(raw_ds, mask_path)
        volume["mask_dataset"] = mask_path
    return {name: volume}
