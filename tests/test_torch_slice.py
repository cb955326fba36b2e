"""The port's main path on the CPU, against the JAX package: tiled
prediction (uint8 outputs within +-1 of the JAX ``Predictor``, both in
fp32) and ws segmentation (labels identical), through the library calls
and through the ``run_prediction`` / ``run_segmentation`` entry points.
"""

import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bootstrapper_torch import resolve_device
from bootstrapper_torch.core import arrays as A
from bootstrapper_torch.core.geometry import Coordinate, Roi
from bootstrapper_torch.models import Model, init_params_numpy, load_params, save_checkpoint
from bootstrapper_torch.models.zoo import get_net_config
from bootstrapper_torch.ops import launch_counts, reset_launch_counts
from bootstrapper_torch.post.segment import waterz_segmentation
from bootstrapper_torch.predict.scan import Predictor, prepare_prediction_outputs, tile_rois
from bootstrapper_torch.utils import tomlio
from bootstrapper_torch.workflows import run_prediction, run_segmentation
from bootstrapper_tpu.core.arrays import open_ds as jax_open_ds
from bootstrapper_tpu.models.model import Model as JModel
from bootstrapper_tpu.post.segment import waterz_segmentation as jax_waterz
from bootstrapper_tpu.predict.scan import Predictor as JPredictor
from bootstrapper_tpu.predict.scan import prepare_prediction_outputs as jax_outputs
from bootstrapper_tpu.predict.scan import tile_rois as jax_tile_rois

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOXEL = (40, 4, 4)
RAW_SHAPE = (2, 32, 32)  # 2x2x2 output tiles of (1, 16, 16)


def _net_config():
    """A narrow 3d_affs (4 -> 24 -> 144 -> 864 channels, so both conv
    routes run) at its smallest tile plus 8 in y and x."""
    nc = get_net_config("3d_affs")
    nc.update(
        num_fmaps=4, fmap_inc_factor=6, input_shape=[29, 100, 100],
        output_shape=[1, 8, 8], shape_increase=[0, 8, 8],
    )
    return nc


@pytest.fixture(scope="module")
def volume(tmp_path_factory):
    """Raw volume (written by the port), params, and the JAX prediction."""
    work = tmp_path_factory.mktemp("slice")
    rng = np.random.default_rng(0)
    raw = rng.integers(0, 256, RAW_SHAPE, dtype=np.uint8)
    raw_path = str(work / "vol.zarr" / "raw")
    ds = A.prepare_ds(raw_path, RAW_SHAPE, (0, 0, 0), VOXEL, np.uint8, chunk_shape=(2, 16, 16))
    ds[ds.roi] = raw
    nc = _net_config()
    params = init_params_numpy(nc, seed=1)

    jm = JModel(nc)
    jp = JPredictor(jm, params, VOXEL, compute_dtype=jnp.float32)
    jraw = jax_open_ds(raw_path)
    jouts = jax_outputs(str(work / "jax.zarr"), jm, jraw.roi, VOXEL, predictor=jp)
    stats = jp.predict(jraw, jouts)
    assert stats["tiles"] == 8
    return {
        "work": work, "raw_path": raw_path, "raw": raw, "net_config": nc,
        "params": params, "jax_affs": jouts["3d_affs"].to_ndarray(),
    }


def _assert_within_one(got, want):
    assert got.shape == want.shape and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_predictor_matches_jax_within_one(volume):
    model = load_params(
        Model(volume["net_config"], compute_dtype=torch.float32), volume["params"]
    )
    p = Predictor(model, VOXEL, device="cpu", compute_dtype=torch.float32)
    raw = A.open_ds(volume["raw_path"])
    outs = prepare_prediction_outputs(
        str(volume["work"] / "port.zarr"), model, raw.roi, VOXEL, predictor=p
    )
    reset_launch_counts()
    stats = p.predict(raw, outs)
    counts = launch_counts()
    assert stats["tiles"] == 8 and stats["voxels_per_sec"] > 0
    assert counts["conv3d.plain"] > 0 and counts["conv3d.library"] > 0
    assert counts["conv3d.kernel"] == 0  # the CPU never launches kernels
    _assert_within_one(outs["3d_affs"].to_ndarray(), volume["jax_affs"])


def test_entry_points_match_jax(volume):
    """run_prediction -> run_segmentation from TOMLs, as a user runs them:
    affinities within +-1 of the JAX Predictor, segmentations equal to the
    JAX package's waterz_segmentation of the same affinities."""
    work = volume["work"]
    setup = work / "setup_entry"
    setup.mkdir()
    with open(setup / "net_config.json", "w") as f:
        json.dump(volume["net_config"], f)
    save_checkpoint(str(setup), volume["params"], 5)
    tomlio.dump(
        {"predict": {"v": {
            "raw_dataset": volume["raw_path"],
            "output_container": str(work / "entry.zarr"),
            "chain": [{"setup_dir": str(setup), "output_prefix": "pred"}],
        }}},
        str(work / "predict.toml"),
    )
    stats = run_prediction(
        str(work / "predict.toml"), device="cpu", compute_dtype=torch.float32
    )
    # two slices deep, deeper than one tiled pass: the entry point streams
    # in z as the JAX package's does, one column of a warm step and a
    # steady step (what the JAX run_prediction returns for this TOML)
    assert stats["v/pred"]["tiles"] == 2 and stats["v/pred"]["steps_per_column"] == 2
    affs_path = str(work / "entry.zarr" / "pred" / "3d_affs")
    affs = A.open_ds(affs_path).to_ndarray()
    _assert_within_one(affs, volume["jax_affs"])

    tomlio.dump(
        {"segment": {"v": {
            "affs_dataset": affs_path,
            "seg_dataset_prefix": str(work / "entry.zarr" / "seg"),
            "ws_params": {"thresholds": [0.3, 0.6]},
        }}},
        str(work / "segment.toml"),
    )
    segs = run_segmentation(str(work / "segment.toml"), device="cpu")
    want = jax_waterz(affs, thresholds=[0.3, 0.6])
    assert set(segs["v"]) == {"0.3", "0.6"}
    for t in (0.3, 0.6):
        seg = A.open_ds(segs["v"][str(t)])
        assert seg.dtype == np.uint64 and seg.roi == A.open_ds(affs_path).roi
        np.testing.assert_array_equal(seg.to_ndarray(), want[t])


def _smooth_affs(seed, shape=(3, 4, 64, 64)):
    from scipy import ndimage

    rng = np.random.default_rng(seed)
    a = ndimage.gaussian_filter(rng.uniform(size=shape), sigma=(0, 0, 3, 3))
    a = (a - a.min()) / (a.max() - a.min())
    return (a * 255).astype(np.uint8)


@pytest.mark.parametrize("fragments_in_xy", [True, False])
def test_waterz_labels_identical_to_jax(fragments_in_xy):
    affs = _smooth_affs(3)
    reset_launch_counts()
    got = waterz_segmentation(affs, fragments_in_xy=fragments_in_xy, device="cpu")
    want = jax_waterz(affs, fragments_in_xy=fragments_in_xy)
    assert set(got) == set(want)
    for t in want:
        assert len(np.unique(want[t])) > 1
        np.testing.assert_array_equal(got[t], want[t])


def test_tile_rois_match_jax():
    total = Roi((0, 4, 8), (12, 50, 70))
    tile = Coordinate((4, 16, 16))
    # the two packages' Roi classes are distinct types: compare reprs
    assert list(map(repr, tile_rois(total, tile))) == list(
        map(repr, jax_tile_rois(total, tile))
    )


def test_without_cuda_entry_points_raise(volume):
    """No silent fallback: without a GPU, the default device raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor(Model(volume["net_config"]), VOXEL)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        waterz_segmentation(_smooth_affs(0))
    assert resolve_device("cpu") == torch.device("cpu")


def test_doctor_and_chip_smoke_refuse_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = dict(os.environ, PYTHONPATH=REPO)
    doc = subprocess.run(
        [sys.executable, "-m", "bootstrapper_torch", "doctor"],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=120,
    )
    assert doc.returncode == 1
    info = json.loads(doc.stdout.strip().splitlines()[-1])
    assert info["cuda_available"] is False and "torch_cuda" in info
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), alone / "chip_smoke.py")
    for cwd in (REPO, str(alone)):
        r = subprocess.run(
            [sys.executable, "chip_smoke.py"],
            capture_output=True, text=True, cwd=cwd, timeout=120,
        )
        assert r.returncode != 0
        assert '"ok": true' not in r.stdout
