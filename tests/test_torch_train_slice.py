"""The port's training slice on the CPU, through the user entry points:
``run_training`` on a synthetic sample (Voronoi labels with background, a
mask) -> a second ``run_training`` that resumes from the first one's
checkpoint -> ``run_prediction`` with the weights it wrote; the
checkpoint also restores in the JAX package's ``load_checkpoint``.  Plus
what the workflow refuses, its overrides file, snapshots, the host RSS
cap and the stall watchdog."""

import json
import os
import time

import jax
import numpy as np
import optax
import pytest
import torch

from bootstrapper_torch.core import arrays as A
from bootstrapper_torch.models import Model, load_checkpoint, load_params
from bootstrapper_torch.models.model import unet_config
from bootstrapper_torch.models.unet import compute_output_shape, min_input_shape
from bootstrapper_torch.models.zoo import get_net_config
from bootstrapper_torch.utils import tomlio
from bootstrapper_torch.utils.stall import StallWatchdog
from bootstrapper_torch.workflows import run_prediction, run_training
from bootstrapper_torch.workflows.train import setup_train
from bootstrapper_tpu.train import loop as JL

VOXEL = (40, 4, 4)
SHAPE = (34, 140, 140)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """This module's torch work on 2 CPU thread(s): the test run uses
    six worker processes at once, and torch's thread pools in all
    of them oversubscribe the cores (each op waits on threads that are not
    scheduled); restored after the module."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)
# the predicted ROI: one z tile and 2 x 2 xy tiles of (6, 16, 16), whose
# inputs lie inside the volume
PREDICT_OFFSET, PREDICT_SHAPE = (14, 48, 48), (6, 32, 32)


def _net_config():
    """3d_affs at 2 -> 6 -> 18 -> 54 channels, its smallest tile plus 4."""
    nc = get_net_config("3d_affs")
    nc.update(num_fmaps=2, fmap_inc_factor=3)
    cfg = unet_config(nc)
    nc["input_shape"] = list(min_input_shape(cfg, (30, 104, 104)))
    nc["output_shape"] = list(compute_output_shape(cfg, nc["input_shape"]))
    nc["shape_increase"] = [0, 0, 0]
    return nc


def _voronoi(shape, n, seed):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, 1, (n, 3)) * np.array(shape)
    grid = np.stack(np.meshgrid(*[np.arange(s) for s in shape], indexing="ij"), -1)
    d = (((grid[..., None, :] - pts) * np.array([4.0, 1.0, 1.0])) ** 2).sum(-1)
    lab = (d.argmin(-1) + 1).astype(np.uint64) << np.uint64(33)  # ids past 2^32
    lab[:, :, :12] = 0  # background
    return lab


@pytest.fixture(scope="module")
def sample():
    rng = np.random.default_rng(0)
    labels = _voronoi(SHAPE, 40, 0)
    # raw: dark membranes between labels, noise
    raw = np.where(np.roll(labels, 1, 2) != labels, 40, 180) + rng.normal(0, 20, SHAPE)
    data = {
        "raw": np.clip(raw, 0, 255).astype(np.uint8),
        "labels": labels,
        "mask": np.ones(SHAPE, np.uint8),
    }
    data["mask"][:2] = 0
    return data


@pytest.fixture
def workdir(tmp_path, sample):
    """The sample (raw, labels, mask) as Zarr, a setup dir, a train and a
    predict TOML."""
    for name, a in sample.items():
        ds = A.prepare_ds(str(tmp_path / "s.zarr" / name), a.shape, (0, 0, 0), VOXEL, a.dtype)
        ds[ds.roi] = a
    setup = tmp_path / "setup" / "3d_affs"
    setup.mkdir(parents=True)
    (setup / "net_config.json").write_text(json.dumps(_net_config()))
    train = {
        "setup_dir": str(setup), "voxel_size": list(VOXEL), "max_iterations": 2,
        "save_checkpoints_every": 1, "save_snapshots_every": 0,
        "samples": [{k: str(tmp_path / "s.zarr" / k) for k in ("raw", "labels", "mask")}],
    }
    tomlio.dump({"train": train}, str(tmp_path / "train.toml"))
    predict = {
        "vol": {
            "raw_dataset": str(tmp_path / "s.zarr" / "raw"), "output_container": str(tmp_path / "s.zarr"),
            "chain": [{"setup_dir": str(setup), "output_prefix": "predictions", "checkpoint_iteration": 3}],
            "roi_offset": [o * v for o, v in zip(PREDICT_OFFSET, VOXEL)],
            "roi_shape": [s * v for s, v in zip(PREDICT_SHAPE, VOXEL)],
        }
    }
    tomlio.dump({"predict": predict}, str(tmp_path / "predict.toml"))
    return tmp_path


def test_train_resume_predict(workdir):
    setup = str(workdir / "setup" / "3d_affs")
    toml = str(workdir / "train.toml")
    first = run_training(toml, device="cpu", compute_dtype=torch.float32)
    assert first["iterations"] == 2 and first["checkpoint"].endswith("model_checkpoint_2")
    assert sorted(f for f in os.listdir(setup) if f.startswith("model_")) == ["model_checkpoint_1", "model_checkpoint_2"]
    second = run_training(toml, device="cpu", compute_dtype=torch.float32, max_iterations=3)
    assert second["iterations"] == 3 and np.isfinite(second["final_loss"])
    assert os.path.exists(toml.replace(".toml", "_modified.toml"))
    log = [json.loads(line) for line in open(os.path.join(setup, "log", "loss.jsonl"))]
    assert [r["iteration"] for r in log] == [2, 3]  # the second run resumed at 2
    ckpt = second["checkpoint"]
    with np.load(ckpt) as data:
        assert int(data["step"]) == 3 and int(data["opt/0000"]) == 3
    # the JAX trainer resumes from it with its optimizer state
    state = JL.load_checkpoint(ckpt, optax.adam(0.5e-4))
    assert int(state.step) == 3 and int(jax.tree_util.tree_leaves(state.opt_state)[0]) == 3

    stats = run_prediction(str(workdir / "predict.toml"), device="cpu", compute_dtype=torch.float32)
    assert stats["vol/predictions"]["tiles"] == 4
    affs = A.open_ds(str(workdir / "s.zarr" / "predictions" / "3d_affs")).to_ndarray()
    assert affs.shape == (9, *PREDICT_SHAPE) and affs.dtype == np.uint8
    # the first tile by hand: the model with the checkpoint's weights
    nc = _net_config()
    model = load_params(Model(nc, compute_dtype=torch.float32), load_checkpoint(ckpt)).eval()
    raw = A.open_ds(str(workdir / "s.zarr" / "raw")).to_ndarray()
    ctx = [(i - o) // 2 for i, o in zip(nc["input_shape"], nc["output_shape"])]
    src = tuple(slice(o - c, o - c + i) for o, c, i in zip(PREDICT_OFFSET, ctx, nc["input_shape"]))
    x = raw[src].astype(np.float32) / 255 * 2 - 1
    with torch.no_grad():
        y = model(torch.from_numpy(x)[None, ..., None])["3d_affs"][0].numpy()
    want = np.round(np.clip(np.moveaxis(y, -1, 0), 0, 1) * 255)
    got = affs[(slice(None),) + tuple(slice(0, n) for n in nc["output_shape"])]
    assert np.abs(got.astype(int) - want).max() <= 1


def _refiner_inputs(name):
    """The zoo refiner's inputs, the input channels taken from them."""
    return {"inputs": get_net_config(name)["inputs"], "in_channels": None}


@pytest.mark.parametrize(
    "change,match",
    [
        # synthetic training of a setup whose input is raw, which the
        # synthetic transform cannot make: refused, naming the input, before
        # the first step (the JAX package fails there with a KeyError)
        pytest.param({"samples": None}, (ValueError, "synthetic training cannot make input 'raw'"),
                     id="change0-synthetic"),
        # refiners with the zoo's inputs train on synthetic labels
        pytest.param({"setup": "3d_affs_from_2d_affs", "net": _refiner_inputs("3d_affs_from_2d_affs")},
                     None, id="change1-synthetic"),
        pytest.param({"fold_xy": True}, (NotImplementedError, "fold_xy"), id="change2-fold_xy"),
        # mesh over one device trains as without it (the JAX package's
        # condition: more than one device)
        pytest.param({"mesh": True}, None, id="change3-mesh"),
        pytest.param({"setup": "3d_affs_from_3d_lsd", "net": _refiner_inputs("3d_affs_from_3d_lsd")},
                     None, id="change4-synthetic"),
    ],
)
def test_unported_configs_raise(workdir, change, match):
    """What the workflow refuses, with the error it raises (``match``), and
    what it trains instead (``match`` None: one narrow iteration and a
    checkpoint): the synthetic setups, and a mesh on one CPU device."""
    cfg = tomlio.load(str(workdir / "train.toml"))["train"]
    setup = workdir / "setup" / "3d_affs"
    if "setup" in change:
        new = workdir / "setup" / change["setup"]
        new.mkdir()
        (new / "net_config.json").write_text((setup / "net_config.json").read_text())
        cfg["setup_dir"] = str(new)
        setup = new
    if "net" in change:
        path = setup / "net_config.json"
        path.write_text(json.dumps({**json.loads(path.read_text()), **change["net"]}))
    for k, v in change.items():
        if k not in ("setup", "net"):
            cfg.pop(k, None) if v is None else cfg.__setitem__(k, v)
    cfg["max_iterations"] = 1
    tomlio.dump({"train": cfg}, str(workdir / "t.toml"))
    if match is None:
        out = run_training(str(workdir / "t.toml"), device="cpu", compute_dtype=torch.float32)
        assert out["iterations"] == 1 and np.isfinite(out["final_loss"])
        assert out["checkpoint"] == str(setup / "model_checkpoint_1")
        return
    with pytest.raises(match[0], match=match[1]):
        run_training(str(workdir / "t.toml"), device="cpu", compute_dtype=torch.float32)


def test_2d_setup_trains(workdir):
    """A 2D setup (a narrow 2d_mtlsd, both heads) through ``run_training``
    at its default batch of 10: the checkpoint holds the JAX layout's 2D
    weights, and the JAX trainer resumes from it."""
    nc = get_net_config("2d_mtlsd")
    nc.update(num_fmaps=2, fmap_inc_factor=2, input_shape=[100, 100], output_shape=[8, 8])
    setup = workdir / "setup" / "2d_mtlsd"
    setup.mkdir()
    (setup / "net_config.json").write_text(json.dumps(nc))
    cfg = tomlio.load(str(workdir / "train.toml"))["train"]
    cfg.update(setup_dir=str(setup), max_iterations=1)
    tomlio.dump({"train": cfg}, str(workdir / "t2d.toml"))
    out = run_training(str(workdir / "t2d.toml"), device="cpu", compute_dtype=torch.float32)
    assert out["iterations"] == 1 and np.isfinite(out["final_loss"])
    with np.load(out["checkpoint"]) as data:
        assert data["params/unet/l_conv/0/layers/0/w"].shape == (3, 3, 3, 2)  # (kh, kw, adj * 1, 2)
    state = JL.load_checkpoint(out["checkpoint"], optax.adam(1e-4))
    assert int(state.step) == 1


def test_setup_train_overrides(workdir):
    toml = str(workdir / "train.toml")
    cfg = setup_train(toml, max_iterations=None, seed=None)
    assert cfg["max_iterations"] == 2 and not os.path.exists(toml.replace(".toml", "_modified.toml"))
    cfg = setup_train(toml, max_iterations=9)
    assert tomlio.load(toml.replace(".toml", "_modified.toml"))["train"]["max_iterations"] == 9


def test_snapshots_and_rss_cap(workdir, monkeypatch):
    """A snapshot Zarr per ``save_snapshots_every``; past ``BS_MAX_RSS_GB``
    the run checkpoints and stops."""
    monkeypatch.setenv("BS_MAX_RSS_GB", "0.001")
    monkeypatch.setenv("BS_RSS_CHECK_EVERY", "1")
    out = run_training(
        str(workdir / "train.toml"), device="cpu", compute_dtype=torch.float32, save_snapshots_every=1,
    )
    setup = workdir / "setup" / "3d_affs"
    assert out["rss_limit_hit"] and out["iterations"] == 1
    assert out["checkpoint"].endswith("model_checkpoint_1")
    snap = A.open_ds(str(setup / "snapshots" / "batch_1.zarr" / "pred_3d_affs")).to_ndarray()
    assert snap.shape == (9, *_net_config()["output_shape"]) and np.isfinite(snap).all()


def test_stall_watchdog_fires_without_heartbeat(monkeypatch):
    fired = []
    w = StallWatchdog(0.2, 0.2, label="test")
    monkeypatch.setattr(w, "_die", lambda: fired.append(w._tag))
    w.start()
    w.beat("it0")
    deadline = time.monotonic() + 10
    while not fired and time.monotonic() < deadline:
        time.sleep(0.05)
    w.stop()
    w._thread.join(timeout=5)
    assert fired == ["it0"] and not w._thread.is_alive()
