"""The port's array layer: uncompressed Zarr v2 read and written with numpy,
in the JAX package's on-disk format (checked by opening each side's
arrays with the other's ``open_ds``), and in-memory arrays."""

import json
import os

import numpy as np
import pytest
import tensorstore

from bootstrapper_torch.core import arrays as A
from bootstrapper_torch.core.geometry import Roi
from bootstrapper_tpu.core import arrays as J
from bootstrapper_tpu.core.geometry import Roi as JRoi


def test_round_trip_partial_chunks_and_read_by_tensorstore(tmp_path):
    path = str(tmp_path / "c.zarr" / "x")
    shape = (3, 10, 37, 29)  # channel axis + ragged edge chunks
    ds = A.prepare_ds(path, shape, (20, 8, 4), (10, 4, 2), np.uint64, chunk_shape=(3, 4, 16, 16))
    rng = np.random.default_rng(0)
    data = rng.integers(0, 2**40, shape, dtype=np.uint64)
    ds[ds.roi] = data
    sub = Roi((40, 20, 10), (50, 40, 20))  # straddles chunk borders
    patch = rng.integers(0, 9, (3, 5, 10, 10), dtype=np.uint64)
    ds[sub] = patch
    data[:, 2:7, 3:13, 3:13] = patch
    back = A.open_ds(path)
    assert back.roi == ds.roi and back.dtype == np.uint64
    np.testing.assert_array_equal(back.to_ndarray(), data)
    np.testing.assert_array_equal(back[sub], patch)
    with open(os.path.join(path, ".zarray")) as f:
        assert json.load(f)["compressor"] is None
    theirs = J.open_ds(path)  # TensorStore reads the same bytes
    assert tuple(theirs.offset) == (20, 8, 4) and tuple(theirs.voxel_size) == (10, 4, 2)
    np.testing.assert_array_equal(theirs.to_ndarray(), data)


def test_reads_uncompressed_arrays_written_by_tensorstore(tmp_path):
    path = str(tmp_path / "j.zarr" / "raw")
    data = np.arange(6 * 20 * 24, dtype=np.uint8).reshape(6, 20, 24)
    store = tensorstore.open(
        {
            "driver": "zarr",
            "kvstore": {"driver": "file", "path": path},
            "metadata": {
                "shape": list(data.shape), "chunks": [4, 8, 8], "dtype": "|u1",
                "compressor": None, "fill_value": 0, "order": "C",
            },
            "create": True,
        },
        write=True,
    ).result()
    store.write(data).result()
    with open(os.path.join(path, ".zattrs"), "w") as f:
        json.dump({"offset": [0, 8, 8], "resolution": [40, 4, 4]}, f)
    arr = A.open_ds(path)  # legacy "resolution" is read as voxel_size
    assert tuple(arr.voxel_size) == (40, 4, 4) and tuple(arr.offset) == (0, 8, 8)
    np.testing.assert_array_equal(arr.to_ndarray(), data)


def test_compressed_array_raises_clearly(tmp_path):
    path = str(tmp_path / "z.zarr" / "raw")
    ds = J.prepare_ds(path, (4, 8, 8), (0, 0, 0), (1, 1, 1), np.uint8)  # zstd
    ds[ds.roi] = np.ones((4, 8, 8), np.uint8)
    with pytest.raises(ValueError, match="uncompressed"):
        A.open_ds(path)


@pytest.mark.parametrize("pad_mode", ["reflect", "constant"])
def test_padded_reads_match_jax(tmp_path, pad_mode):
    path = str(tmp_path / "p.zarr" / "raw")
    data = np.random.default_rng(1).integers(0, 255, (4, 12, 12), dtype=np.uint8)
    ds = A.prepare_ds(path, data.shape, (0, 0, 0), (2, 1, 1), np.uint8)
    ds[ds.roi] = data
    roi = Roi((-30, -5, 4), (40, 20, 10))  # reflects several times in z
    got = A.open_ds(path).to_ndarray(roi, pad_mode=pad_mode)
    want = J.open_ds(path).to_ndarray(JRoi(roi.offset, roi.shape), pad_mode=pad_mode)
    np.testing.assert_array_equal(got, want)


def test_memory_array_and_frame_checks(tmp_path):
    data = np.zeros((2, 8, 8), np.float32)
    arr = A.Array.from_ndarray(data, (0, 0, 0), (1, 1, 1))
    arr[Roi((1, 2, 2), (1, 4, 4))] = 1.0
    assert data.sum() == 16  # writes go into the given array
    with pytest.raises(ValueError, match="aligned"):
        A.Array.from_ndarray(data, (0, 0, 0), (1, 2, 2))[Roi((0, 1, 0), (1, 2, 2))]
    with pytest.raises(IndexError):
        arr[Roi((0, 0, 0), (3, 8, 8))]
    path = str(tmp_path / "f.zarr" / "x")
    A.prepare_ds(path, (4, 8), (0, 0), (1, 1), np.uint8, chunk_shape=(2, 2))[Roi((0, 0), (4, 8))] = 7
    again = A.prepare_ds(path, (4, 4), (2, 0), (1, 1), np.uint8)  # overwrites
    assert again.roi == Roi((2, 0), (4, 4)) and again.to_ndarray().sum() == 0
    assert sorted(os.listdir(path)) == [".zarray", ".zattrs"]  # old chunks gone
