"""World-unit arrays backed by numpy: in memory, or Zarr v2 on disk.

The same interface as the JAX package's ``core/arrays.py`` (``roi``,
``offset``, ``voxel_size``, ROI indexing, ``to_ndarray``, ``open_ds`` /
``prepare_ds``) with the same on-disk format: a Zarr v2 directory holding
``.zarray`` metadata, one C-order file per chunk named ``i.j.k``, and
world metadata (``offset``, ``voxel_size``, ``axis_names``, ``units``) in
``.zattrs``.  Chunks are read and written with plain numpy and JSON, raw
or through one of three codecs: ``zstd`` (the JAX package's default
compressor; ``zstandard`` is imported where a zstd chunk is first read or
written), ``zlib`` and ``gzip`` (the standard library).  Any other codec,
and any filter, raises when the array is opened.  The port writes
uncompressed unless ``prepare_ds`` is given a ``compressor``.

Arrays may have non-spatial leading dimensions (e.g. affinity channels);
only the trailing ``len(voxel_size)`` dimensions are spatial and addressed
by ROIs.
"""

from __future__ import annotations

import gzip
import itertools
import json
import os
import threading
import zlib
from typing import Optional, Sequence

import numpy as np

from .geometry import Coordinate, Roi


CODECS = ("zstd", "zlib", "gzip")


def _zstandard():
    try:
        import zstandard
    except ImportError as e:
        raise ImportError(
            "the Python package 'zstandard' is needed to read or write "
            "zstd-compressed Zarr chunks (the JAX package's default compressor)"
        ) from e
    return zstandard


def encode_chunk(raw: bytes, compressor: Optional[dict]) -> bytes:
    """One chunk's bytes as ``compressor`` (a Zarr v2 codec dict) stores them."""
    if compressor is None:
        return raw
    cid, level = compressor["id"], compressor.get("level")
    if cid == "zstd":
        return _zstandard().ZstdCompressor(level=3 if level is None else level).compress(raw)
    if cid == "zlib":
        return zlib.compress(raw, 6 if level is None else level)
    if cid == "gzip":
        return gzip.compress(raw, compresslevel=6 if level is None else level, mtime=0)
    raise ValueError(f"cannot write Zarr codec {cid!r}; bootstrapper_torch writes {CODECS}")


def decode_chunk(data: bytes, compressor: Optional[dict], nbytes: int) -> bytes:
    """The raw bytes of one stored chunk of ``nbytes`` bytes."""
    if compressor is None:
        return data
    cid = compressor["id"]
    if cid == "zstd":
        return _zstandard().ZstdDecompressor().decompress(data, max_output_size=nbytes)
    if cid == "zlib":
        return zlib.decompress(data)
    if cid == "gzip":
        return gzip.decompress(data)
    raise ValueError(f"cannot decode Zarr codec {cid!r}")


class ZarrStore:
    """A Zarr v2 array on disk (raw or ``CODECS``-compressed chunks), read
    and written by slices."""

    def __init__(self, path: str):
        self.path = path
        with open(os.path.join(path, ".zarray")) as f:
            meta = json.load(f)
        if meta.get("zarr_format", 2) != 2:
            raise ValueError(f"{path}: only Zarr v2 is supported")
        self.compressor = meta.get("compressor")
        if self.compressor is not None and self.compressor.get("id") not in CODECS:
            raise ValueError(
                f"{path} is stored with codec {self.compressor.get('id')!r} "
                f"({self.compressor}); bootstrapper_torch decodes {CODECS} "
                "and uncompressed chunks"
            )
        if meta.get("filters"):
            raise ValueError(
                f"{path} is stored with filters {meta['filters']}; "
                "bootstrapper_torch reads Zarr arrays without filters"
            )
        if meta.get("order", "C") != "C":
            raise ValueError(f"{path}: only C-order chunks are supported")
        self.shape = tuple(int(s) for s in meta["shape"])
        self.chunks = tuple(int(c) for c in meta["chunks"])
        self.dtype = np.dtype(meta["dtype"])
        self.fill_value = meta.get("fill_value") or 0
        self.sep = meta.get("dimension_separator", ".")

    @classmethod
    def create(cls, path, shape, chunks, dtype, compressor: Optional[dict] = None) -> "ZarrStore":
        if compressor is not None and compressor.get("id") not in CODECS:
            raise ValueError(f"cannot write Zarr codec {compressor.get('id')!r}; bootstrapper_torch writes {CODECS}")
        os.makedirs(path, exist_ok=True)
        for name in os.listdir(path):  # mode "w": drop the old chunks
            p = os.path.join(path, name)
            if not name.startswith(".z") and os.path.isfile(p):
                os.unlink(p)
        meta = {
            "zarr_format": 2,
            "shape": [int(s) for s in shape],
            "chunks": [int(c) for c in chunks],
            "dtype": np.dtype(dtype).str,
            "compressor": compressor,
            "fill_value": 0,
            "order": "C",
            "filters": None,
        }
        with open(os.path.join(path, ".zarray"), "w") as f:
            json.dump(meta, f, indent=2)
        return cls(path)

    def _chunk_file(self, idx) -> str:
        return os.path.join(self.path, self.sep.join(str(i) for i in idx))

    def _read_chunk(self, idx) -> np.ndarray:
        p = self._chunk_file(idx)
        if not os.path.exists(p):
            return np.full(self.chunks, self.fill_value, self.dtype)
        if self.compressor is None:
            return np.fromfile(p, self.dtype).reshape(self.chunks)
        nbytes = int(np.prod(self.chunks)) * self.dtype.itemsize
        with open(p, "rb") as f:
            raw = decode_chunk(f.read(), self.compressor, nbytes)
        if len(raw) != nbytes:
            raise ValueError(f"{p}: decoded {len(raw)} bytes, a chunk holds {nbytes}")
        return np.frombuffer(raw, self.dtype).reshape(self.chunks).copy()

    def _chunk_ranges(self, sl):
        """Per chunk overlapping ``sl``: (chunk index, slices into the
        chunk, slices into the request)."""
        per_dim = []
        for (a, b), c in zip(sl, self.chunks):
            per_dim.append(
                [
                    (i, slice(max(a, i * c) - i * c, min(b, (i + 1) * c) - i * c),
                     slice(max(a, i * c) - a, min(b, (i + 1) * c) - a))
                    for i in range(a // c, -(-b // c))
                ]
            )
        for combo in itertools.product(*per_dim):
            yield (
                tuple(c[0] for c in combo),
                tuple(c[1] for c in combo),
                tuple(c[2] for c in combo),
            )

    def _bounds(self, key) -> list:
        key = key if isinstance(key, tuple) else (key,)
        key = key + (slice(None),) * (len(self.shape) - len(key))
        out = []
        for k, n in zip(key, self.shape):
            if not isinstance(k, slice) or k.step not in (None, 1):
                raise IndexError("ZarrStore takes unit-step slices only")
            a, b, _ = k.indices(n)
            out.append((a, max(a, b)))
        return out

    def read(self, key=()) -> np.ndarray:
        sl = self._bounds(key)
        out = np.empty([b - a for a, b in sl], self.dtype)
        if out.size == 0:
            return out
        for idx, src, dst in self._chunk_ranges(sl):
            out[dst] = self._read_chunk(idx)[src]
        return out

    def write(self, key, value) -> None:
        sl = self._bounds(key)
        value = np.broadcast_to(
            np.asarray(value, self.dtype), [b - a for a, b in sl]
        )
        for idx, src, dst in self._chunk_ranges(sl):
            full = all(
                s.start == 0 and s.stop == c for s, c in zip(src, self.chunks)
            )
            chunk = (
                np.empty(self.chunks, self.dtype) if full else self._read_chunk(idx)
            )
            chunk[src] = value[dst]
            # one name per writer: threads of one process write too
            tmp = f"{self._chunk_file(idx)}.{os.getpid()}.{threading.get_ident()}.tmp"
            if self.compressor is None:
                chunk.tofile(tmp)
            else:
                with open(tmp, "wb") as f:
                    f.write(encode_chunk(chunk.tobytes(), self.compressor))
            os.replace(tmp, self._chunk_file(idx))


class MemoryStore:
    """A numpy array with the ``ZarrStore`` read/write interface."""

    def __init__(self, data: np.ndarray, chunks=None):
        self.data = data
        self.shape = data.shape
        self.dtype = data.dtype
        self.chunks = tuple(chunks) if chunks is not None else data.shape

    def read(self, key=()) -> np.ndarray:
        return np.array(self.data[key])

    def write(self, key, value) -> None:
        self.data[key] = value


class Array:
    """An array with world-coordinate metadata."""

    def __init__(self, store, offset, voxel_size, path: str = ""):
        self.store = store
        self.voxel_size = Coordinate(voxel_size)
        self.offset = Coordinate(offset)
        sdims = self.voxel_size.dims
        self.spatial_dims = sdims
        shape = tuple(store.shape)
        self.channel_shape = shape[: len(shape) - sdims]
        self.spatial_shape = shape[len(shape) - sdims :]
        self.path = path

    @classmethod
    def from_ndarray(cls, data: np.ndarray, offset, voxel_size) -> "Array":
        """An in-memory array (writes go into ``data``)."""
        return cls(MemoryStore(data), offset, voxel_size)

    # -- basic properties --------------------------------------------------

    @property
    def shape(self) -> tuple:
        return tuple(self.store.shape)

    @property
    def dtype(self):
        return self.store.dtype

    @property
    def roi(self) -> Roi:
        return Roi(self.offset, Coordinate(self.spatial_shape) * self.voxel_size)

    # -- IO ----------------------------------------------------------------

    def _spatial_slices(self, roi: Roi) -> tuple:
        if not self.roi.contains(roi):
            raise IndexError(f"{roi} not contained in {self.roi}")
        for b, e, v, o in zip(roi.begin, roi.end, self.voxel_size, self.offset):
            # reject unaligned ROIs instead of silently floor-snapping
            if (b - o) % v or (e - o) % v:
                raise ValueError(
                    f"{roi} is not aligned to the voxel grid "
                    f"(voxel_size {tuple(self.voxel_size)}, "
                    f"offset {tuple(self.offset)})"
                )
        return roi.to_slices(self.voxel_size, self.offset)

    def _key(self, key):
        if isinstance(key, Roi):
            return (slice(None),) * len(self.channel_shape) + self._spatial_slices(key)
        return key

    def __getitem__(self, key) -> np.ndarray:
        if isinstance(key, Coordinate):
            # one world point -> its value (all channels)
            idx = [(k - o) // v for k, o, v in zip(key, self.offset, self.voxel_size)]
            sl = (slice(None),) * len(self.channel_shape) + tuple(slice(i, i + 1) for i in idx)
            return self.store.read(sl)[(Ellipsis,) + (0,) * len(idx)]
        return self.store.read(self._key(key))

    def __setitem__(self, key, value):
        self.store.write(self._key(key), np.asarray(value, dtype=self.dtype))

    def to_ndarray(self, roi: Optional[Roi] = None, pad_mode: str = "constant") -> np.ndarray:
        """Read ``roi`` (default: full array), padding out-of-bounds with
        ``pad_mode`` ('constant' -> zeros, or 'reflect')."""
        if roi is None:
            return self.store.read(())
        if self.roi.contains(roi):
            return self[roi]
        inside = self.roi.intersect(roi)
        if inside.empty:
            vshape = tuple(Coordinate(roi.shape) / self.voxel_size)
            return np.zeros(self.channel_shape + vshape, dtype=self.dtype)
        data = self[inside]
        lo = (inside.begin - roi.begin) / self.voxel_size
        hi = (roi.end - inside.end) / self.voxel_size
        pads = [(0, 0)] * len(self.channel_shape) + [
            (int(a), int(b)) for a, b in zip(lo, hi)
        ]
        return np.pad(data, pads, mode=pad_mode)


def _read_attrs(path: str) -> dict:
    p = os.path.join(path, ".zattrs")
    if os.path.exists(p):
        with open(p) as f:
            return json.load(f)
    return {}


def _write_attrs(path: str, attrs: dict):
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, ".zattrs"), "w") as f:
        json.dump(attrs, f, indent=2)


def _normalize_attrs(attrs: dict, ndim: int) -> dict:
    """Map legacy attr names (resolution/transform) to canonical ones."""
    out = dict(attrs)
    if "voxel_size" not in out:
        if "resolution" in out:
            out["voxel_size"] = out["resolution"]
        elif "transform" in out and "scale" in out["transform"]:
            out["voxel_size"] = out["transform"]["scale"]
    if "offset" not in out:
        out["offset"] = [0] * len(out.get("voxel_size", [1] * ndim))
    if "voxel_size" not in out:
        out["voxel_size"] = [1] * ndim
    return out


def open_ds(path: str, mode: str = "r") -> Array:
    """Open an existing Zarr v2 array with world metadata.  ``mode`` is
    the JAX package's (``"r"`` or ``"r+"``); the port's arrays are written
    through the same store either way."""
    if mode not in ("r", "r+"):
        raise ValueError(f"open_ds mode must be 'r' or 'r+', got {mode!r}")
    path = os.path.abspath(path).rstrip("/")
    store = ZarrStore(path)
    attrs = _normalize_attrs(_read_attrs(path), len(store.shape))
    return Array(store, attrs["offset"], attrs["voxel_size"], path=path)


def prepare_ds(
    path: str,
    shape: Sequence[int],
    offset: Sequence[int],
    voxel_size: Sequence[int],
    dtype,
    chunk_shape: Optional[Sequence[int]] = None,
    axis_names: Optional[Sequence[str]] = None,
    units: Optional[Sequence[str]] = None,
    mode: str = "w",
    compressor: Optional[dict] = None,
) -> Array:
    """Create a Zarr v2 array with world metadata (``mode="w"``: drop any
    array there), or, with ``mode="a"`` or ``"r+"``, open the array
    already there with its ``.zattrs``, which must have the asked offset
    and voxel size (and then also its shape and dtype); another mode only
    opens an existing array.

    ``shape`` is the full voxel shape including channel dims; ``offset`` and
    ``voxel_size`` cover only the trailing spatial dims.  ``compressor`` is
    a Zarr v2 codec dict of ``CODECS`` (e.g. ``{"id": "zstd", "level": 3}``,
    the JAX package's default); the port's default, None, writes raw chunks.
    """
    path = os.path.abspath(path).rstrip("/")
    voxel_size = Coordinate(voxel_size)
    offset = Coordinate(offset)
    shape = tuple(int(s) for s in shape)
    sdims = voxel_size.dims
    if mode != "w" and (mode not in ("a", "r+") or os.path.exists(os.path.join(path, ".zarray"))):
        # an existing array keeps its metadata: the asked frame must match
        store = ZarrStore(path)
        attrs = _normalize_attrs(_read_attrs(path), len(store.shape))
        have_off, have_vs = Coordinate(attrs["offset"]), Coordinate(attrs["voxel_size"])
        if have_off != offset or have_vs != voxel_size:
            raise ValueError(
                f"{path} already exists with offset {tuple(have_off)} / "
                f"voxel_size {tuple(have_vs)}; requested "
                f"{tuple(offset)} / {tuple(voxel_size)} (mode={mode!r} "
                "keeps existing metadata — use mode='w' to recreate)"
            )
        if store.shape != shape or store.dtype != np.dtype(dtype):
            raise ValueError(
                f"{path} already exists with shape {store.shape} and dtype {store.dtype}; "
                f"requested {shape} / {np.dtype(dtype)} (mode={mode!r})"
            )
        return Array(store, have_off, have_vs, path=path)
    if chunk_shape is None:
        chunk_shape = shape[: len(shape) - sdims] + tuple(
            min(s, 256 if i >= len(shape) - 2 else 64)
            for i, s in enumerate(shape[len(shape) - sdims :], len(shape) - sdims)
        )
    store = ZarrStore.create(path, shape, chunk_shape, dtype, compressor)
    if axis_names is None:
        axis_names = [f"c{i}^" for i in range(len(shape) - sdims)] + ["zyx"[3 - sdims + i] for i in range(sdims)]
    _write_attrs(
        path,
        {
            "offset": list(offset),
            "voxel_size": list(voxel_size),
            "axis_names": list(axis_names),
            "units": list(units) if units is not None else ["nm"] * sdims,
        },
    )
    return Array(store, offset, voxel_size, path=path)
