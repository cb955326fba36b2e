"""The port's array layer: Zarr v2 read and written with numpy, raw or
zstd/zlib/gzip-compressed, in the JAX package's on-disk format (checked by
opening each side's arrays with the other's ``open_ds``), ``prepare_ds``'s
modes, and in-memory arrays; and the batch-sharded prediction's ``BS_INT8``
refusal."""

import json
import os

import numpy as np
import pytest
import tensorstore

from bootstrapper_torch.core import arrays as A
from bootstrapper_torch.core.geometry import Roi
from bootstrapper_torch.workflows import run_prediction
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
    """A codec the port does not decode (blosc) fails when the array is
    opened, naming the codec; so does a filter."""
    path = str(tmp_path / "z.zarr" / "raw")
    blosc = {"id": "blosc", "cname": "lz4", "clevel": 5, "shuffle": 1}
    ds = J.prepare_ds(path, (4, 8, 8), (0, 0, 0), (1, 1, 1), np.uint8, compressor=blosc)
    ds[ds.roi] = np.ones((4, 8, 8), np.uint8)
    with pytest.raises(ValueError, match="codec 'blosc'"):
        A.open_ds(path)
    with open(os.path.join(path, ".zarray")) as f:
        meta = json.load(f)
    meta.update(compressor=None, filters=[{"id": "delta", "dtype": "|u1"}])
    with open(os.path.join(path, ".zarray"), "w") as f:
        json.dump(meta, f)
    with pytest.raises(ValueError, match="delta"):
        A.open_ds(path)


@pytest.mark.parametrize("compressor", [None, {"id": "zlib", "level": 6}, {"id": "gzip", "level": 5}])
def test_reads_compressed_arrays_written_by_jax(tmp_path, compressor):
    """Arrays the JAX package's ``prepare_ds`` writes, with its default
    compressor (None there means zstd level 3) or zlib or gzip, read back as
    written, ragged edge chunks, never-written chunks and channels
    included; the port writes the same codecs for the JAX package to read."""
    path = str(tmp_path / "j.zarr" / "affs")
    shape = (3, 5, 21, 19)
    data = np.random.default_rng(2).integers(0, 2**40, shape, dtype=np.uint64)
    ds = J.prepare_ds(path, shape, (40, 8, 4), (10, 4, 2), np.uint64, chunk_shape=(3, 2, 8, 8),
                      compressor=compressor)
    ds[JRoi((40, 8, 4), (40, 84, 38))] = data[:, :4]  # the last z chunk stays unwritten
    data[:, 4:] = 0
    want = compressor or {"id": "zstd", "level": 3}
    with open(os.path.join(path, ".zarray")) as f:
        assert json.load(f)["compressor"]["id"] == want["id"]
    arr = A.open_ds(path)
    assert tuple(arr.offset) == (40, 8, 4) and tuple(arr.voxel_size) == (10, 4, 2)
    np.testing.assert_array_equal(arr.to_ndarray(), data)
    mine = str(tmp_path / "p.zarr" / "affs")
    out = A.prepare_ds(mine, shape, (40, 8, 4), (10, 4, 2), np.uint64, chunk_shape=(3, 2, 8, 8), compressor=want)
    out[out.roi] = data
    np.testing.assert_array_equal(J.open_ds(mine).to_ndarray(), data)
    np.testing.assert_array_equal(A.open_ds(mine).to_ndarray(), data)


def test_prepare_ds_append_keeps_the_array(tmp_path):
    """``mode="a"`` (and ``"r+"``) keep an existing array, its chunks and
    its ``.zattrs``, and raise on another frame, as the JAX package's do."""
    path = str(tmp_path / "a.zarr" / "x")
    ds = A.prepare_ds(path, (4, 8, 8), (8, 0, 0), (2, 1, 1), np.uint8)
    ds[ds.roi] = 5
    with open(os.path.join(path, ".zattrs")) as f:
        attrs = json.load(f)
    attrs["extra"] = "kept"
    with open(os.path.join(path, ".zattrs"), "w") as f:
        json.dump(attrs, f)
    for mode in ("a", "r+"):
        again = A.prepare_ds(path, (4, 8, 8), (8, 0, 0), (2, 1, 1), np.uint8, mode=mode)
        assert again.roi == ds.roi and int(again.to_ndarray().min()) == 5
        with open(os.path.join(path, ".zattrs")) as f:
            assert json.load(f)["extra"] == "kept"
        with pytest.raises(ValueError, match="already exists with offset"):
            A.prepare_ds(path, (4, 8, 8), (0, 0, 0), (2, 1, 1), np.uint8, mode=mode)
    new = A.prepare_ds(str(tmp_path / "a.zarr" / "y"), (2, 4), (0, 0), (1, 1), np.uint8, mode="a")
    assert new.to_ndarray().sum() == 0  # a missing array is created


INT8_VOXEL = (40, 4, 4)
INT8_ROI = (8 * 40, 32 * 4, 40 * 4)  # the volume's first 8 sections' first 32 rows: 40 tiles


def _int8_setup(root):
    """The raw volume and tiny 3d_affs net ((24, 48, 48) -> (4, 8, 8)) of
    ``tests/test_torch_quant.py``'s predictor tests, whose int8 bound against
    the JAX package's jitted graph they set; a numpy-seeded checkpoint at
    iteration 1 and a predict TOML whose output container is ``root``'s."""
    from bootstrapper_torch.models import init_params_numpy, save_checkpoint
    from bootstrapper_torch.models.zoo import get_net_config
    from bootstrapper_torch.utils import tomlio

    nc = get_net_config("3d_affs")
    nc.update(
        num_fmaps=2, fmap_inc_factor=2, input_shape=[24, 48, 48], output_shape=[4, 8, 8], shape_increase=[0, 0, 0],
        downsample_factors=[[1, 2, 2]] * 2,
        kernel_size_down=[[[3, 3, 3], [3, 3, 3]]] * 3, kernel_size_up=[[[3, 3, 3], [3, 3, 3]]] * 2,
    )
    nc["outputs"] = {"3d_affs": {"dtype": "uint8", "dims": 3, "neighborhood": [[-1, 0, 0], [0, -1, 0], [0, 0, -1]],
                                 "grow_boundary": 1}}
    setup = root / "setup"
    setup.mkdir()
    (setup / "net_config.json").write_text(json.dumps(nc))
    params = init_params_numpy(nc, 0)
    save_checkpoint(str(setup), params, 1)
    shape = (22, 60, 40)
    raw = A.prepare_ds(str(root / "v.zarr" / "raw"), shape, (0, 0, 0), INT8_VOXEL, np.uint8)
    raw[raw.roi] = np.random.default_rng(22).integers(0, 255, shape, dtype=np.uint8)
    chain = [{"setup_dir": str(setup), "output_prefix": "pred", "checkpoint_iteration": 1}]
    tomlio.dump({"predict": {"v": {"raw_dataset": raw.path, "output_container": str(root / "out.zarr"),
                                   "chain": chain}}}, str(root / "predict.toml"))
    return nc, params, raw, str(root / "predict.toml")


def test_run_prediction_refuses_int8(tmp_path, monkeypatch):
    """``BS_INT8=1`` with ``sharded="batch"`` over two logical devices, no
    longer refused: each conv-pass input's scale is taken over the batch of
    both devices' tiles, so the affinities equal, uint8 for uint8, the
    one-device run two tiles a batch, and the JAX package's
    ``ShardedPredictor`` on two virtual devices within the int8 bound of
    ``tests/test_torch_quant.py`` (+-1 on under 1% of voxels; fp32
    compute)."""
    import jax
    import jax.numpy as jnp
    import torch

    from bootstrapper_tpu.models.model import Model as JModel
    from bootstrapper_tpu.predict.scan import prepare_prediction_outputs as jax_outputs
    from bootstrapper_tpu.predict.sharded import ShardedPredictor as JShardedPredictor

    monkeypatch.setenv("BS_INT8", "1")
    monkeypatch.setenv("BS_ZSTREAM", "0")  # a batch of tiles, not lockstep streams
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        got = {}
        for name, kw in (("sharded", {"device": ["cpu", "cpu"], "sharded": "batch"}),
                         ("batch_tiles_2", {"device": "cpu", "batch_tiles": 2})):
            (tmp_path / name).mkdir()
            nc, params, raw, toml = _int8_setup(tmp_path / name)
            stats = run_prediction(toml, compute_dtype=torch.float32, roi_offset=(0, 0, 0),
                                   roi_shape=INT8_ROI, **kw)["v/pred"]
            got[name] = A.open_ds(str(tmp_path / name / "out.zarr" / "pred" / "3d_affs")).to_ndarray()
        assert stats["tiles"] == 2 * 4 * 5
    finally:
        torch.set_num_threads(threads)
    np.testing.assert_array_equal(got["sharded"], got["batch_tiles_2"])
    jm = JModel(nc)
    jsp = JShardedPredictor(jm, params, INT8_VOXEL, devices=jax.devices()[:2], compute_dtype=jnp.float32)
    jraw = J.open_ds(raw.path)
    jroi = JRoi((0, 0, 0), INT8_ROI)
    jouts = jax_outputs(str(tmp_path / "jax.zarr"), jm, jroi, INT8_VOXEL, predictor=jsp)
    jsp.predict(jraw, jouts, jroi)
    want = jouts["3d_affs"].to_ndarray()
    diff = np.abs(got["sharded"].astype(int) - want.astype(int))
    assert got["sharded"].shape == want.shape and diff.max() <= 1 and (diff != 0).mean() < 1e-2


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
