"""The port's spans (``utils/profiling.py:span``) on the CPU: none while no
profiler records, and under ``torch.profiler`` the predict pipeline's and
the training step's, nested as ``PERF.md``'s span table lists them; the
operator's trace under ``BS_PROFILE``; and the predictors'
``voxels_per_sec`` as the ROI's output voxels a second."""

import json
import os
import re

import numpy as np
import pytest
import torch

from bootstrapper_torch.core import arrays as A
from bootstrapper_torch.core.geometry import Roi
from bootstrapper_torch.models import Model, init_params_numpy, load_params, save_checkpoint
from bootstrapper_torch.models.zoo import get_net_config
from bootstrapper_torch.pipeline.training import TrainingPipeline
from bootstrapper_torch.predict.scan import Predictor, prepare_prediction_outputs
from bootstrapper_torch.predict.sharded import ShardedPredictor
from bootstrapper_torch.predict.spatial import SpatialShardedPredictor, spatial_shape_increase
from bootstrapper_torch.predict.zstream import ZStreamPredictor
from bootstrapper_torch.train.loop import TrainState, make_optimizer, make_train_step
from bootstrapper_torch.train.sampler import Sample
from bootstrapper_torch.utils import profiling, tomlio
from bootstrapper_torch.workflows import run_prediction, run_training
from bootstrapper_torch.workflows.train import TRACE_ITERATIONS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOXEL = (40, 4, 4)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """This module's torch work on 2 CPU threads: the test run uses several
    worker processes at once; restored after the module."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _net_config():
    """A tiny 3d_affs net that streams in z: (24,48,48) -> (4,8,8)."""
    nc = get_net_config("3d_affs")
    nc.update(
        num_fmaps=2,
        fmap_inc_factor=2,
        input_shape=[24, 48, 48],
        output_shape=[4, 8, 8],
        shape_increase=[0, 0, 0],
        downsample_factors=[[1, 2, 2]] * 2,
        kernel_size_down=[[[3, 3, 3], [3, 3, 3]]] * 3,
        kernel_size_up=[[[3, 3, 3], [3, 3, 3]]] * 2,
    )
    nc["outputs"] = {
        "3d_affs": {"dtype": "uint8", "dims": 3, "neighborhood": [[-1, 0, 0], [0, -1, 0], [0, 0, -1]],
                    "grow_boundary": 1}
    }
    return nc


def _model(nc):
    return load_params(Model(nc, compute_dtype=torch.float32), init_params_numpy(nc, 0))


def _raw(path, shape):
    ds = A.prepare_ds(path, shape, (0, 0, 0), VOXEL, np.uint8)
    ds[ds.roi] = np.random.default_rng(0).integers(0, 255, shape, dtype=np.uint8)
    return ds


def _host_spans(prof) -> dict:
    """``{name: [(start, end)]}`` of the host's ``bs.`` ranges in a trace."""
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation() and e.device_type() == torch.autograd.DeviceType.CPU and e.name().startswith("bs."):
            out.setdefault(e.name(), []).append((e.start_ns(), e.start_ns() + e.duration_ns()))
    return out


def _all_inside(inner, outer) -> bool:
    return all(any(a <= s and e <= b for a, b in outer) for s, e in inner)


def test_span_without_a_profiler_is_the_shared_null_context(monkeypatch):
    def refused(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refused)
    got = profiling.span("bs.predict.dispatch")
    assert got is profiling.span("bs.train.step") is profiling._UNTRACED
    with got:
        with profiling.span("bs.train.forward"):
            torch.ones(4).sum()
    monkeypatch.undo()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        torch.ones(4).sum()
    assert _host_spans(prof) == {}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.span("bs.predict.write"):
            torch.ones(4).sum()
    assert list(_host_spans(prof)) == ["bs.predict.write"]


@pytest.mark.parametrize("route", ["stream", "tiled"])
def test_predict_spans_nest_once_a_step(tmp_path, route):
    nc = _net_config()
    model = _model(nc)
    raw = _raw(str(tmp_path / "r.zarr" / "raw"), (14, 24, 16))
    if route == "stream":
        predictor = ZStreamPredictor(model, VOXEL, device="cpu", compute_dtype=torch.float32)
    else:
        predictor = Predictor(model, VOXEL, device="cpu", compute_dtype=torch.float32, batch_tiles=4)
    outs = prepare_prediction_outputs(str(tmp_path / "o.zarr"), model, raw.roi, VOXEL, predictor)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        stats = predictor.predict(raw, outs)
    sp = _host_spans(prof)
    steps = stats["tiles"] if route == "stream" else -(-stats["tiles"] // 4)
    assert steps > 1
    assert len(sp["bs.predict.dispatch"]) == len(sp["bs.predict.drain"]) == steps
    assert len(sp["bs.predict.read_wait"]) == steps + 1  # the last takes the reader's end
    assert len(sp["bs.predict.device_wait"]) == len(sp["bs.predict.write"]) == steps
    assert "bs.predict.read" not in sp  # the reader thread's: an all-threads profiler's alone
    assert _all_inside(sp["bs.predict.device_wait"] + sp["bs.predict.write"], sp["bs.predict.drain"])
    if route == "stream":
        warm, steady = sp["bs.zstream.warm"], sp["bs.zstream.steady"]
        assert len(warm) == stats["columns"] and len(warm) + len(steady) == steps
        assert _all_inside(warm + steady, sp["bs.predict.dispatch"])
    else:
        assert not any(k.startswith("bs.zstream.") for k in sp)


def _voronoi_sample(shape, seed=0) -> Sample:
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, 1, (12, 3)) * np.array(shape)
    grid = np.stack(np.meshgrid(*[np.arange(s) for s in shape], indexing="ij"), -1)
    labels = (((grid[..., None, :] - pts) * np.array([4.0, 1.0, 1.0])) ** 2).sum(-1).argmin(-1) + 1
    raw = rng.integers(0, 256, shape, dtype=np.uint8)
    mask = np.ones(shape, dtype=np.uint8)
    return Sample(*(A.Array.from_ndarray(a, (0, 0, 0), VOXEL) for a in (raw, labels.astype(np.uint64), mask)))


def test_train_spans_nest_once_a_step():
    nc = _net_config()
    pipe = TrainingPipeline(nc, VOXEL, [_voronoi_sample((28, 56, 56))], batch_size=2, seed=1, num_threads=1,
                            prefetch=2, device="cpu")
    model = _model(nc)
    state, step = TrainState(0, model, make_optimizer(model, 1e-4)), make_train_step()
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            for _ in range(2):
                state, _ = step(state, pipe.transform_batch(next(pipe.loader)))
    finally:
        pipe.stop()
    sp = _host_spans(prof)
    for name in ("loader_wait", "transform", "upload", "step", "forward", "backward", "optimizer"):
        assert len(sp[f"bs.train.{name}"]) == 2, name
    for name in ("augment", "targets"):  # once a sample
        assert len(sp[f"bs.train.{name}"]) == 4, name
    assert "bs.train.draw" not in sp  # the loader's workers'
    parts = sp["bs.train.upload"] + sp["bs.train.augment"] + sp["bs.train.targets"]
    assert _all_inside(parts, sp["bs.train.transform"])
    assert _all_inside(sp["bs.train.forward"] + sp["bs.train.backward"] + sp["bs.train.optimizer"],
                       sp["bs.train.step"])
    assert not _all_inside(sp["bs.train.loader_wait"], sp["bs.train.transform"] + sp["bs.train.step"])


def test_every_span_is_in_the_span_table():
    names = set()
    for root, _, files in os.walk(os.path.join(REPO, "bootstrapper_torch")):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(root, f)) as fh:
                    names |= set(re.findall(r'"(bs\.[a-z_]+\.[a-z_]+)"', fh.read()))
    assert len(names) >= 18, sorted(names)
    with open(os.path.join(REPO, "PERF.md")) as f:
        perf = f.read()
    assert [n for n in sorted(names) if f"`{n}`" not in perf] == []


def _setup(tmp_path, nc) -> str:
    setup = tmp_path / "setup"
    setup.mkdir()
    with open(setup / "net_config.json", "w") as f:
        json.dump(nc, f)
    save_checkpoint(str(setup), init_params_numpy(nc, 3), 1)
    return str(setup)


def test_bs_profile_traces_a_prediction(tmp_path, monkeypatch):
    nc = _net_config()
    raw = _raw(str(tmp_path / "r.zarr" / "raw"), (14, 24, 16))
    toml = str(tmp_path / "p.toml")
    tomlio.dump({"predict": {"v": {"raw_dataset": raw.path, "output_container": str(tmp_path / "o.zarr"),
                                   "chain": [{"setup_dir": _setup(tmp_path, nc), "output_prefix": "pred"}]}}}, toml)
    monkeypatch.setenv("BS_PROFILE", str(tmp_path / "prof"))
    stats = run_prediction(toml, device="cpu", compute_dtype=torch.float32)
    assert "steps_per_column" in stats["v/pred"]
    with open(tmp_path / "prof" / "predict" / "v" / "pred" / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"bs.predict.dispatch", "bs.predict.drain", "bs.zstream.warm"} <= names
    # the reader thread's span, where this torch profiles every thread
    assert ("bs.predict.read" in names) == bool(profiling._all_threads())


def test_bs_profile_traces_twenty_training_iterations(tmp_path, monkeypatch):
    """``_train`` traces iterations 11-30 of a run: twenty steps."""
    sample = _voronoi_sample((28, 56, 56))
    paths = {}
    for name, arr in zip(("raw", "labels", "mask"), (sample.raw, sample.labels, sample.mask)):
        paths[name] = str(tmp_path / "s.zarr" / name)
        a = arr.to_ndarray()
        ds = A.prepare_ds(paths[name], a.shape, (0, 0, 0), VOXEL, a.dtype)
        ds[ds.roi] = a
    toml = str(tmp_path / "t.toml")
    tomlio.dump({"train": {"setup_dir": _setup(tmp_path, _net_config()), "voxel_size": list(VOXEL),
                           "max_iterations": 32, "save_checkpoints_every": 1000, "save_snapshots_every": 0,
                           "samples": [paths]}}, toml)
    monkeypatch.setenv("BS_PROFILE", str(tmp_path / "prof"))
    run_training(toml, device="cpu", compute_dtype=torch.float32)
    with open(tmp_path / "prof" / "train" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    steps = [e for e in events if e.get("name") == "bs.train.step"]
    assert len(steps) == len(TRACE_ITERATIONS) == 20


def _predictor(kind, model):
    if kind == "tiled":
        return Predictor(model, VOXEL, device="cpu", compute_dtype=torch.float32)
    if kind == "stream":
        return ZStreamPredictor(model, VOXEL, device="cpu", compute_dtype=torch.float32)
    if kind == "sharded":
        return ShardedPredictor(model, VOXEL, devices=["cpu", "cpu"], compute_dtype=torch.float32)
    inc = spatial_shape_increase(model.net_config, 2)
    return SpatialShardedPredictor(model, VOXEL, devices=["cpu", "cpu"], shape_increase=inc,
                                   compute_dtype=torch.float32)


@pytest.mark.parametrize("kind", ["tiled", "stream", "sharded", "spatial"])
def test_voxels_per_sec_counts_the_roi_once(tmp_path, kind):
    """Each predictor's rate is the requested ROI's output voxels over the
    pass's seconds, however many voxels its tiles or steps compute."""
    nc = _net_config()
    model = _model(nc)
    predictor = _predictor(kind, model)
    shape = tuple(max(s, t) + 3 for s, t in zip((9, 20, 12), predictor.output_tile))
    raw = _raw(str(tmp_path / "r.zarr" / "raw"), shape)
    roi = Roi((40, 4, 8), tuple((s - 2) * v for s, v in zip(shape, VOXEL)))
    outs = prepare_prediction_outputs(str(tmp_path / "o.zarr"), model, raw.roi, VOXEL, predictor)
    stats = predictor.predict(raw, outs, roi)
    want = np.prod([s - 2 for s in shape])
    assert stats["tiles"] > 1
    assert stats["voxels_per_sec"] == pytest.approx(want / stats["seconds"], rel=1e-12)
