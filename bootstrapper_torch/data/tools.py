"""Volume data tools: the ``bs utils`` capability set (the JAX package's
``data/tools.py`` over the port's arrays, blockwise runner and native
library; host work, nothing runs on the device).

Equivalents of the reference data commands (reference
``bootstrapper/data/{bbox,convert,mask,scale_pyramid,clahe,merge}.py``):

- ``bbox``          crop to the nonzero bounding box (+padding), world
                    offset recomputed (``bbox.py:24-84``)
- ``convert``       TIFF / 2D-stack / image dir -> Zarr with dtype
                    rescale and world metadata (``convert.py:14-173``)
- ``mask``          raw mask (blurred-intensity threshold + binary
                    closing) and object mask (>0), blockwise
                    (``mask.py:13-149``)
- ``scale_pyramid`` multiscale s0..sN: images averaged, labels strided
                    (``scale_pyramid.py:14-246``)
- ``clahe``         contrast-limited adaptive histogram equalisation,
                    blockwise per section (``clahe.py``)
- ``merge``         bulk id merges via LUT pairs (``merge.py:14-126``)
"""

from __future__ import annotations

import glob
import os
from typing import Optional, Sequence

import numpy as np
from scipy import ndimage

from .. import native
from ..core.arrays import Array, open_ds, prepare_ds
from ..core.blockwise import BlockwiseTask, run_blockwise_or_raise
from ..core.geometry import Coordinate


def bbox_crop(in_path: str, out_path: str, padding: int = 0) -> Array:
    """Crop to the nonzero bounding box with ``padding`` voxels."""
    arr = open_ds(in_path)
    data = arr.to_ndarray()
    nz = np.nonzero(data)
    if len(nz[0]) == 0:
        raise ValueError("array is empty; nothing to crop to")
    lo = [max(0, int(n.min()) - padding) for n in nz]
    hi = [
        min(s, int(n.max()) + 1 + padding)
        for n, s in zip(nz, data.shape)
    ]
    cropped = data[tuple(slice(a, b) for a, b in zip(lo, hi))]
    sdims = arr.spatial_dims
    spatial_lo = lo[len(lo) - sdims :]
    offset = arr.offset + Coordinate(spatial_lo) * arr.voxel_size
    out = prepare_ds(
        out_path, cropped.shape, offset, arr.voxel_size, cropped.dtype
    )
    out[out.roi] = cropped
    return out


def _rescale_to_uint8(data: np.ndarray) -> np.ndarray:
    if data.dtype == np.uint8:
        return data
    lo, hi = float(data.min()), float(data.max())
    if hi <= lo:
        return np.zeros(data.shape, np.uint8)
    return ((data.astype(np.float64) - lo) / (hi - lo) * 255).astype(np.uint8)


def convert_to_zarr(
    in_path: str,
    out_path: str,
    voxel_size: Sequence[int] = (1, 1, 1),
    offset: Optional[Sequence[int]] = None,
    dtype=None,
    crop: Optional[Sequence[Sequence[int]]] = None,
    axis_names=None,
) -> Array:
    """Read TIFF stack / image directory / npy into a Zarr volume."""
    import imageio.v3 as iio

    if os.path.isdir(in_path):
        files = sorted(
            glob.glob(os.path.join(in_path, "*.tif*"))
            + glob.glob(os.path.join(in_path, "*.png"))
        )
        if not files:
            raise ValueError(f"no images in {in_path}")
        data = np.stack([iio.imread(f) for f in files])
    elif in_path.endswith(".npy"):
        data = np.load(in_path)
    else:
        data = np.asarray(iio.imread(in_path))
    if crop is not None:
        data = data[tuple(slice(a, b) for a, b in crop)]
    if dtype is not None:
        dtype = np.dtype(dtype)
        if dtype == np.uint8:
            data = _rescale_to_uint8(data)
        else:
            data = data.astype(dtype)
    offset = offset or [0] * len(voxel_size)
    out = prepare_ds(
        out_path, data.shape, offset, voxel_size, data.dtype,
        axis_names=axis_names,
    )
    out[out.roi] = data
    return out


def make_raw_mask(
    in_path: str, out_path: str, sigma: float = 3.0,
    closing_iterations: int = 5, block_shape=(8, 512, 512),
    num_workers: int = 8,
) -> Array:
    """Foreground mask of a raw volume: blurred intensity > 0, then 2D
    binary closing per section (``mask.py:13-39`` capability)."""
    raw = open_ds(in_path)
    vs = raw.voxel_size
    out = prepare_ds(
        out_path, raw.spatial_shape, raw.offset, vs, np.uint8
    )
    context = Coordinate((0, 8 * vs[1], 8 * vs[2]))

    def process(block):
        rroi = block.read_roi.intersect(raw.roi)
        data = raw.to_ndarray(rroi).astype(np.float32)
        blurred = ndimage.gaussian_filter(data, sigma=(0, sigma, sigma))
        mask = blurred > blurred.mean() * 0.1
        structure = np.zeros((1, 3, 3), bool)
        structure[0] = True
        mask = ndimage.binary_closing(
            mask, structure=structure, iterations=closing_iterations
        )
        wroi = block.write_roi.intersect(raw.roi)
        lo = (wroi.begin - rroi.begin) / vs
        hi = lo + wroi.shape / vs
        core = tuple(slice(int(a), int(b)) for a, b in zip(lo, hi))
        out[wroi] = mask[core].astype(np.uint8)

    run_blockwise_or_raise(
        BlockwiseTask(
            "make_raw_mask", raw.roi, Coordinate(block_shape) * vs,
            context, context, process, num_workers=num_workers,
        )
    )
    return out


def make_obj_mask(
    in_path: str, out_path: str, block_shape=(8, 512, 512),
    num_workers: int = 8,
) -> Array:
    """labels > 0 -> uint8, blockwise (``mask.py:40-81`` capability)."""
    labels = open_ds(in_path)
    vs = labels.voxel_size
    out = prepare_ds(
        out_path, labels.spatial_shape, labels.offset, vs, np.uint8
    )

    def process(block):
        wroi = block.write_roi.intersect(labels.roi)
        out[wroi] = (labels.to_ndarray(wroi) > 0).astype(np.uint8)

    run_blockwise_or_raise(
        BlockwiseTask(
            "make_obj_mask", labels.roi, Coordinate(block_shape) * vs,
            Coordinate.zeros(3), Coordinate.zeros(3), process,
            num_workers=num_workers,
        )
    )
    return out


def scale_pyramid(
    in_path: str,
    scales: int = 3,
    factor: Sequence[int] = (1, 2, 2),
    is_labels: Optional[bool] = None,
) -> list:
    """Write s1..sN downscale levels next to the input (renamed s0).

    Images are mean-pooled, labels strided (``scale_pyramid.py:14-127``
    capability).
    """
    arr = open_ds(in_path)
    if is_labels is None:
        is_labels = np.issubdtype(arr.dtype, np.integer) and arr.dtype.itemsize >= 4

    base = in_path.rstrip("/")
    if os.path.basename(base).startswith("s0"):
        # already a pyramid level: write s1..sN NEXT to it, not inside
        base = os.path.dirname(base)
    else:
        # move into a pyramid group: path/s0
        s0_path = os.path.join(base, "s0")
        data0 = arr.to_ndarray()
        import shutil

        tmp = base + "__tmp_pyramid"
        os.makedirs(tmp, exist_ok=True)
        s0 = prepare_ds(
            os.path.join(tmp, "s0"), data0.shape, arr.offset,
            arr.voxel_size, arr.dtype,
        )
        s0[s0.roi] = data0
        shutil.rmtree(base)
        os.rename(tmp, base)
        arr = open_ds(os.path.join(base, "s0"))

    paths = [os.path.join(base, "s0")]
    prev = arr
    for level in range(1, scales + 1):
        data = prev.to_ndarray()
        f = tuple(factor)
        if is_labels:
            down = data[tuple(slice(None, None, ff) for ff in f)]
        else:
            # mean pooling over factor blocks (trim remainder)
            trim = tuple(
                slice(0, (s // ff) * ff) for s, ff in zip(data.shape, f)
            )
            d = data[trim].astype(np.float32)
            for ax, ff in enumerate(f):
                if ff > 1:
                    shape = list(d.shape)
                    shape[ax] //= ff
                    shape.insert(ax + 1, ff)
                    d = d.reshape(shape).mean(axis=ax + 1)
            down = d.astype(data.dtype)
        vs = Coordinate(prev.voxel_size) * Coordinate(f)
        path = os.path.join(base, f"s{level}")
        ds = prepare_ds(path, down.shape, prev.offset, vs, down.dtype)
        ds[ds.roi] = down
        paths.append(path)
        prev = ds
    return paths


def clahe_2d(
    image: np.ndarray, tiles: int = 8, clip_limit: float = 0.01,
    nbins: int = 256,
) -> np.ndarray:
    """Contrast-limited adaptive histogram equalisation of one section.

    Per-tile clipped histograms -> CDF mappings, bilinearly interpolated
    between tile centres (standard CLAHE; no skimage available).
    """
    img = image.astype(np.float32)
    lo, hi = float(img.min()), float(img.max())
    if hi <= lo:
        return image
    norm = (img - lo) / (hi - lo)
    H, W = img.shape
    th, tw = -(-H // tiles), -(-W // tiles)
    # per-tile mapping tables
    maps = np.zeros((tiles, tiles, nbins), np.float32)
    for i in range(tiles):
        for j in range(tiles):
            tile = norm[i * th : (i + 1) * th, j * tw : (j + 1) * tw]
            hist, _ = np.histogram(tile, bins=nbins, range=(0, 1))
            hist = hist.astype(np.float32) / max(tile.size, 1)
            clip = clip_limit
            excess = np.clip(hist - clip, 0, None).sum()
            hist = np.minimum(hist, clip) + excess / nbins
            cdf = np.cumsum(hist)
            if cdf[-1] > 0:
                maps[i, j] = cdf / cdf[-1]
            else:
                # tile entirely past the image edge (narrow section):
                # identity mapping, not 0/0 = NaN leaking into the
                # bilinear interpolation
                maps[i, j] = np.linspace(0, 1, nbins, dtype=np.float32)
    # bilinear interpolation of mappings at every pixel
    ys = (np.arange(H) - th / 2) / th
    xs = (np.arange(W) - tw / 2) / tw
    y0 = np.clip(np.floor(ys).astype(int), 0, tiles - 1)
    y1 = np.clip(y0 + 1, 0, tiles - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, tiles - 1)
    x1 = np.clip(x0 + 1, 0, tiles - 1)
    wy = np.clip(ys - y0, 0, 1)[:, None]
    wx = np.clip(xs - x0, 0, 1)[None, :]
    bins = np.clip((norm * (nbins - 1)).astype(int), 0, nbins - 1)
    out = (
        maps[y0[:, None], x0[None, :], bins] * (1 - wy) * (1 - wx)
        + maps[y1[:, None], x0[None, :], bins] * wy * (1 - wx)
        + maps[y0[:, None], x1[None, :], bins] * (1 - wy) * wx
        + maps[y1[:, None], x1[None, :], bins] * wy * wx
    )
    result = out * (hi - lo) + lo
    return result.astype(image.dtype)


def clahe(
    in_path: str, out_path: str, block_shape=(8, 512, 512),
    clip_limit: float = 0.01, num_workers: int = 8,
) -> Array:
    """Blockwise per-section CLAHE."""
    raw = open_ds(in_path)
    vs = raw.voxel_size
    out = prepare_ds(
        out_path, raw.spatial_shape, raw.offset, vs, raw.dtype
    )

    def process(block):
        wroi = block.write_roi.intersect(raw.roi)
        data = raw.to_ndarray(wroi)
        result = np.stack(
            [clahe_2d(sec, clip_limit=clip_limit) for sec in data]
        )
        out[wroi] = result

    run_blockwise_or_raise(
        BlockwiseTask(
            "clahe", raw.roi, Coordinate(block_shape) * vs,
            Coordinate.zeros(3), Coordinate.zeros(3), process,
            num_workers=num_workers,
        )
    )
    return out


def merge_ids(
    in_path: str, out_path: str, merge_pairs: Sequence[Sequence[int]],
    block_shape=(8, 512, 512), num_workers: int = 8,
) -> Array:
    """Blockwise LUT merge: each (a, b) pair maps a -> b
    (``merge.py:14-126`` capability, via union-find over the pairs)."""
    seg = open_ds(in_path)
    vs = seg.voxel_size
    # Resolve transitive merges while honouring the documented
    # direction: applying pairs in order, each (a, b) folds a's current
    # group into b's, and the SURVIVING id is b's current surviving id
    # (the reference's LUT maps members to the user-chosen key,
    # ``merge.py:20-25``) — not an arbitrary union-find root.
    ids = sorted({int(x) for pair in merge_pairs for x in pair})
    dense = {x: i for i, x in enumerate(ids)}
    parent = list(range(len(ids)))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    rep = list(range(len(ids)))  # group root -> surviving dense id
    for a, b in merge_pairs:
        ra, rb = find(dense[int(a)]), find(dense[int(b)])
        target = rep[rb]
        if ra != rb:
            parent[ra] = rb
        rep[find(rb)] = target
    lut_old = np.array(ids, np.uint64)
    lut_new = np.array([ids[rep[find(i)]] for i in range(len(ids))], np.uint64)

    out = prepare_ds(
        out_path, seg.spatial_shape, seg.offset, vs, np.uint64
    )

    def process(block):
        wroi = block.write_roi.intersect(seg.roi)
        out[wroi] = native.replace_values(
            seg.to_ndarray(wroi), lut_old, lut_new
        )

    run_blockwise_or_raise(
        BlockwiseTask(
            "merge", seg.roi, Coordinate(block_shape) * vs,
            Coordinate.zeros(3), Coordinate.zeros(3), process,
            num_workers=num_workers,
        )
    )
    return out
