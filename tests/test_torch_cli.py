"""The port's command line (``bootstrapper_torch/cli``) against the JAX
package's, on the CPU: the same command surface (names, options, short
flags, aliases, a bare ``prepare``), the same round configs from
``prepare``, ``run`` dispatching each stage config to the same workflow,
and from one JAX-layout checkpoint the same predict, segment, evaluate and
filter results.  The volume is ``tests/test_cli_round.py``'s (24, 96, 96)
one on its narrow net, written by the JAX package (zstd Zarr), so the port
reads the arrays a JAX ``bs prepare`` would have left.

Tolerances: uint8 affinities within +-1 on under 1e-3 of voxels, as in
``tests/test_torch_zstream_predict.py`` (both predictors in fp32 for this
stage: bf16 on two CPU backends rounds apart by more); segment, evaluate and filter run on the same affinities (the
JAX package's, written into the port's dataset), so their outputs must be
equal and the VOI within 1e-12, as in ``tests/test_torch_round.py``.
"""

import functools
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
from click.testing import CliRunner

from bootstrapper_torch.cli import cli as tcli
from bootstrapper_torch.core import arrays as A
from bootstrapper_torch.models import Model
from bootstrapper_torch.models.weights import save_checkpoint
from bootstrapper_torch.utils import tomlio
from bootstrapper_torch.workflows import predict as port_workflow
from bootstrapper_tpu.cli import cli as jcli
from bootstrapper_tpu.core import arrays as J
from bootstrapper_tpu.models.model import Model as JModel
from bootstrapper_tpu.predict import zstream as jax_zstream
from bootstrapper_tpu.predict.scan import Predictor as JPredictor
from bootstrapper_tpu.workflows import predict as jax_workflow

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ITERATIONS = 10
# tests/test_cli_round.py's narrow net
TINY_3D_NET = dict(
    num_fmaps=2,
    fmap_inc_factor=2,
    input_shape=[12, 48, 48],
    output_shape=[4, 8, 8],
    shape_increase=[0, 0, 0],
    downsample_factors=[[1, 2, 2]] * 2,
    kernel_size_down=[
        [[1, 3, 3], [1, 3, 3]],
        [[3, 3, 3], [3, 3, 3]],
        [[3, 3, 3], [3, 3, 3]],
    ],
    kernel_size_up=[[[1, 3, 3], [1, 3, 3]], [[1, 3, 3], [1, 3, 3]]],
)
NBHD = [[-1, 0, 0], [0, -1, 0], [0, 0, -1]]
STAGES = ["01_train_3d_affs.toml", "02_predict.toml", "03_segment.toml", "04_evaluate.toml", "05_filter.toml"]


def invoke(pkg: str, args, **kw):
    """``args`` through the JAX package's command line or the port's (on
    the CPU); a failure raises."""
    cli, args = (jcli, list(args)) if pkg == "jax" else (tcli, ["--device", "cpu", *args])
    res = CliRunner().invoke(cli, args, catch_exceptions=False, **kw)
    assert res.exit_code == 0, res.output
    return res


def _write_volume(root) -> tuple:
    """tests/test_cli_round.py's volume, written by the JAX package."""
    shape, vs = (24, 96, 96), (1, 1, 1)
    rng = np.random.default_rng(0)
    labels = np.zeros(shape, np.uint32)
    labels[:, :48, :] = 1
    labels[:, 48:, :] = 2
    raw = np.full(shape, 200, np.float32)
    raw[:, 46:50, :] = 30
    raw += rng.normal(0, 10, shape)
    raw = np.clip(raw, 0, 255).astype(np.uint8)
    container = str(root / "vol.zarr")
    for name, data in [("raw", raw), ("labels", labels)]:
        ds = J.prepare_ds(f"{container}/{name}", shape, (0, 0, 0), vs, data.dtype)
        ds[ds.roi] = data
    volumes = {"vol": {
        "raw_dataset": f"{container}/raw", "labels_dataset": f"{container}/labels",
        "voxel_size": list(vs), "output_container": container,
    }}
    tomlio.dump({"volumes": volumes}, str(root / "volumes.toml"))
    return container


def _shrink(setup_dir):
    path = os.path.join(setup_dir, "net_config.json")
    with open(path) as f:
        nc = json.load(f)
    nc.update(TINY_3D_NET)
    nc["outputs"]["3d_affs"]["neighborhood"] = NBHD
    nc["outputs"]["3d_affs"]["dims"] = 3
    with open(path, "w") as f:
        json.dump(nc, f)


def _substituted(d, root):
    if isinstance(d, dict):
        return {_substituted(k, root): _substituted(v, root) for k, v in d.items()}
    if isinstance(d, list):
        return [_substituted(v, root) for v in d]
    return d.replace(root, "<root>") if isinstance(d, str) else d


def _tree(root: str) -> dict:
    """Every file under ``root/round_1``: TOMLs loaded, others as bytes."""
    out = {}
    for d, _, files in os.walk(os.path.join(root, "round_1")):
        for f in files:
            p = os.path.join(d, f)
            out[os.path.relpath(p, root)] = tomlio.load(p) if f.endswith(".toml") else open(p, "rb").read()
    return _substituted(out, root)


class _JPredictor32(JPredictor):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, compute_dtype=jnp.float32, **kwargs)


class _JZStream32(jax_zstream.ZStreamPredictor):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, compute_dtype=jnp.float32, **kwargs)


@pytest.fixture(scope="module")
def rounds(tmp_path_factory):
    """Round 1 prepared by a bare ``prepare`` through each command line in
    its own directory, and the stages predict -> filter run through each
    from one JAX-layout checkpoint (the JAX package's init at seed 0)."""
    base = tmp_path_factory.mktemp("cli")
    out = {"configs": {}}
    for pkg in ("jax", "port"):
        root = base / pkg
        container = _write_volume(root)
        invoke(pkg, [
            "prepare", "-b", str(root), "-v", str(root / "volumes.toml"), "-m", "3d_affs",
            "-r", "round_1", "--max-iterations", str(ITERATIONS), "--gt-labels", f"{container}/labels",
        ])
        out["configs"][pkg] = _tree(str(root))
        setup = str(root / "round_1/setups/3d_affs")
        _shrink(setup)
        params = JModel.from_setup(setup).init(jax.random.PRNGKey(0))
        save_checkpoint(setup, jax.tree_util.tree_map(np.asarray, params), ITERATIONS)
        out[pkg] = {"root": root, "container": container}

    def stage(args):
        for pkg in ("jax", "port"):
            invoke(pkg, [a.replace("<round>", str(out[pkg]["root"] / "round_1")) for a in args])

    affs = f"3d_affs/{ITERATIONS - 1}/3d_affs"
    with pytest.MonkeyPatch.context() as mp:  # both packages' predictors in fp32
        mp.setattr(jax_workflow, "Predictor", _JPredictor32)
        mp.setattr(jax_zstream, "ZStreamPredictor", _JZStream32)
        mp.setattr(port_workflow, "run_prediction", functools.partial(port_workflow.run_prediction, compute_dtype=torch.float32))
        stage(["pred", "<round>/02_predict.toml"])
    out["affs"] = {pkg: A.open_ds(f"{out[pkg]['container']}/{affs}").to_ndarray() for pkg in ("jax", "port")}
    # segment, evaluate and filter the same affinities
    ds = A.open_ds(f"{out['port']['container']}/{affs}", "r+")
    ds[ds.roi] = out["affs"]["jax"]
    stage(["seg", "<round>/03_segment.toml", "-p", "thresholds=[0.3,0.5]"])
    stage(["eval", "<round>/04_evaluate.toml"])
    stage(["refine", "<round>/05_filter.toml"])
    return out


def test_prepare_round_writes_the_jax_configs(rounds):
    port, jax_ = rounds["configs"]["port"], rounds["configs"]["jax"]
    assert sorted(port) == sorted(jax_) and port == jax_
    assert all(f"round_1/{s}" in port for s in STAGES)
    assert "round_1/setups/3d_affs/net_config.json" in port


def test_predict_matches_jax(rounds):
    got, want = rounds["affs"]["port"], rounds["affs"]["jax"]
    assert got.shape == want.shape == (3, 24, 96, 96) and got.dtype == np.uint8
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1 and (diff != 0).mean() < 1e-3


def test_predict_auto_tile_matches_jax(rounds):
    """``predict --auto-tile`` through both command lines (fp32): the
    same one tile for the volume, not streamed, and the same affinities
    within +-1."""
    affs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_workflow, "Predictor", _JPredictor32)
        mp.setattr(port_workflow, "run_prediction", functools.partial(port_workflow.run_prediction, compute_dtype=torch.float32))
        for pkg in ("jax", "port"):
            res = invoke(pkg, ["predict", str(rounds[pkg]["root"] / "round_1/02_predict.toml"), "--auto-tile"])
            assert ": 1 tiles," in res.output
            affs[pkg] = A.open_ds(f"{rounds[pkg]['container']}/3d_affs/{ITERATIONS - 1}/3d_affs").to_ndarray()
    diff = np.abs(affs["port"].astype(np.int16) - affs["jax"].astype(np.int16))
    assert diff.max() <= 1 and (diff != 0).mean() < 1e-3


@pytest.mark.parametrize(
    "setup,volume,budget",
    [
        ("3d_affs", (64, 512, 512), None),  # the volume bounds the tile
        ("3d_affs", (200, 2000, 2000), 45_000_000),  # the budget does
        ("3d_affs", (200, 2000, 2000), 120_000_000),
        ("3d_lsd", (30, 300, 900), 45_000_000),
        ("2d_mtlsd", (64, 512, 512), None),  # a 2D setup keeps its increase
    ],
)
def test_auto_shape_increase_matches_jax(setup, volume, budget):
    from bootstrapper_torch.models.zoo import get_net_config
    from bootstrapper_torch.predict.scan import auto_shape_increase
    from bootstrapper_tpu.predict.scan import auto_shape_increase as jax_auto

    nc = get_net_config(setup)
    want = jax_auto(nc, volume, max_input_voxels=budget or 45_000_000)
    assert auto_shape_increase(nc, volume, max_input_voxels=budget or 45_000_000) == want
    if budget is None:  # the port's default budget on the CPU, one H100's
        assert auto_shape_increase(nc, volume, device="cpu") == want


def _segmentations(rounds, pkg) -> dict:
    seg_dir = f"{rounds[pkg]['container']}/post/{ITERATIONS - 1}/segmentations_ws"
    return {name: A.open_ds(os.path.join(seg_dir, name)).to_ndarray() for name in sorted(os.listdir(seg_dir))}


def test_segment_matches_jax(rounds):
    got, want = _segmentations(rounds, "port"), _segmentations(rounds, "jax")
    assert sorted(got) == sorted(want) == ["mean--0_3", "mean--0_5"]
    for name in got:
        np.testing.assert_array_equal(got[name], want[name])


def test_evaluate_matches_jax(rounds):
    res = {}
    for pkg in ("jax", "port"):
        with open(f"{rounds[pkg]['container']}/eval/vol_results.json") as f:
            res[pkg] = _substituted(json.load(f), str(rounds[pkg]["root"]))
    assert sorted(res["port"]) == sorted(res["jax"]) and len(res["port"]) == 2
    for path, entry in res["port"].items():
        for k, v in res["jax"][path]["voi"].items():
            assert entry["voi"][k] == pytest.approx(v, abs=1e-12), k


def test_filter_matches_jax(rounds):
    for name in ("labels", "mask"):
        got = A.open_ds(f"{rounds['port']['container']}/pseudo_gt/round_1/{name}")
        want = A.open_ds(f"{rounds['jax']['container']}/pseudo_gt/round_1/{name}")
        assert got.roi == want.roi and got.dtype == want.dtype
        np.testing.assert_array_equal(got.to_ndarray(), want.to_ndarray())
    nxt = {pkg: _substituted(tomlio.load(str(rounds[pkg]["root"] / "round_1/next_volumes.toml")),
                             str(rounds[pkg]["root"])) for pkg in ("jax", "port")}
    assert nxt["port"] == nxt["jax"]


def test_run_dispatches_like_jax(rounds, monkeypatch):
    """``run <round_dir>`` sends each stage config to the same workflow,
    in the same order, in both packages (the workflows replaced by
    recorders)."""
    import bootstrapper_torch.workflows as tw
    import bootstrapper_tpu.workflows as jw

    calls = {"jax": [], "port": []}
    for pkg, mod in (("jax", jw), ("port", tw)):
        for stage, fn, ret in (
            ("train", "run_training", {"iterations": ITERATIONS, "rss_limit_hit": False}),
            ("predict", "run_prediction", {}), ("segment", "run_segmentation", {}),
            ("evaluate", "run_evaluation", {}), ("filter", "run_filter", {}),
        ):
            def record(config_file, *a, _pkg=pkg, _fn=fn, _ret=ret, **kw):
                calls[_pkg].append((_fn, os.path.basename(config_file), kw.get("mode")))
                return _ret

            monkeypatch.setattr(getattr(mod, stage), fn, record)
    for pkg in ("jax", "port"):
        invoke(pkg, ["run", str(rounds[pkg]["root"] / "round_1")])
    assert calls["port"] == calls["jax"]
    assert [c[1] for c in calls["port"]] == STAGES


def _commands(cli, path):
    import click

    group = cli
    for name in path:
        group = group.commands[name]
    return {n: c for n, c in group.commands.items() if not isinstance(c, click.Group)}


def _surface(cmd) -> list:
    return sorted(
        (tuple(p.opts), tuple(p.secondary_opts), p.nargs, getattr(p, "multiple", False),
         getattr(p, "is_flag", False), p.param_type_name)
        for p in cmd.params
    )


@pytest.mark.parametrize("path", [(), ("prepare",), ("utils",)])
def test_command_surface_matches_jax(path):
    """Every command of the JAX package's group exists in the port's with
    the same arguments, options and short flags; the port's ``doctor`` is
    its own one-line report."""
    port, jax_ = _commands(tcli, path), _commands(jcli, path)
    assert sorted(port) == sorted(jax_)
    for name in sorted(set(jax_) - {"doctor"}):
        assert _surface(port[name]) == _surface(jax_[name]), name
    if not path:
        assert sorted(tcli.commands) == sorted(jcli.commands)


@pytest.mark.parametrize("alias", ["prep", "pred", "infer", "seg", "eval", "refine"])
def test_aliases_resolve_like_jax(alias):
    import click

    names = [cli.get_command(click.Context(cli), alias).name for cli in (tcli, jcli)]
    assert names[0] == names[1] != alias


REFUSALS = {
    # int8 over a batch spread across devices (one scale per device, where
    # the JAX package takes one over the batch): a recorded departure
    "int8": (["predict", "<round>/02_predict.toml", "--sharded"], "Queue C"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusals_name_their_queue_item(rounds, case, monkeypatch):
    args, word = REFUSALS[case]
    if case == "int8":
        monkeypatch.setenv("BS_INT8", "1")
    round_dir = str(rounds["port"]["root"] / "round_1")
    args = ["--device", "cpu"] + [a.replace("<round>", round_dir) for a in args]
    res = CliRunner().invoke(tcli, args)
    assert res.exit_code != 0
    assert word in (res.output + repr(res.exception))


def _multi_device_run(rounds, tmp_path, case: str, device: str):
    """One multi-device command on a copy of the port's round (its setup and
    checkpoint), on ``device``; returns what it wrote: the affinities, or
    the trained checkpoint's parameters and the final loss."""
    src = rounds["port"]["root"] / "round_1"
    work = tmp_path / device.replace(",", "_")
    setup = work / "setup"
    shutil.copytree(str(src / "setups" / "3d_affs"), str(setup))
    if case == "mesh":
        cfg = tomlio.load(str(src / STAGES[0]))
        # a sample one input tile in size: every draw is the same crop, so
        # that both runs train on the same batch (the loader's threads
        # deliver draws in no fixed order)
        nc = json.loads((setup / "net_config.json").read_text())
        (sample,) = cfg["train"]["samples"]
        for key, path in list(sample.items()):
            arr = A.open_ds(path)
            crop = A.Roi(arr.roi.begin, A.Coordinate(nc["input_shape"]) * arr.voxel_size)
            out = A.prepare_ds(str(work / "sample.zarr" / key), tuple(nc["input_shape"]), crop.begin,
                               arr.voxel_size, arr.dtype)
            out[out.roi] = arr.to_ndarray(crop)
            sample[key] = out.path
        cfg["train"].update(setup_dir=str(setup), max_iterations=ITERATIONS + 1, save_snapshots_every=0)
        tomlio.dump(cfg, str(work / "train.toml"))
        res = invoke("port", ["--device", device, "train", str(work / "train.toml"), "--mesh"])
        assert f"'iterations': {ITERATIONS + 1}" in res.output
        with np.load(str(setup / f"model_checkpoint_{ITERATIONS + 1}")) as data:
            params = {k: data[k] for k in data.files if k.startswith("params/")}
        with open(setup / "log" / "loss.jsonl") as f:
            return params, json.loads(f.read().splitlines()[-1])["loss"]
    cfg = tomlio.load(str(src / STAGES[1]))
    for vol in cfg["predict"].values():
        vol["output_container"] = str(work / "out.zarr")
        for link in vol["chain"]:
            link["setup_dir"] = str(setup)
    tomlio.dump(cfg, str(work / "predict.toml"))
    args = ["predict", str(work / "predict.toml")]
    if case == "sharded_batch":
        args += ["--sharded"]
    if case == "sharded_spatial":  # one auto tile for the volume, split over the devices
        args += ["-s", "spatial", "--auto-tile"]
    invoke("port", ["--device", device, *args])
    (prefix,) = [link["output_prefix"] for vol in cfg["predict"].values() for link in vol["chain"]]
    return A.open_ds(str(work / "out.zarr" / prefix / "3d_affs")).to_ndarray()


MULTI_DEVICE = ["sharded_batch", "sharded_spatial", "mesh"]


@pytest.mark.parametrize("case", MULTI_DEVICE)
def test_multi_device_commands_run(rounds, case, monkeypatch, tmp_path, request):
    """``--device cpu,cpu`` with ``predict --sharded``, ``predict -s
    spatial`` and ``train --mesh`` (two gloo ranks) run through the command
    line, and give what the one-device command gives: the same affinities
    (a batch of tiles computes each tile as one device does; a split tile
    differs from the whole one only within 4 voxels of its seam, as in
    ``tests/test_torch_spatial_predict.py``), and after one mesh step the
    same loss within 1e-5 and parameters within atol 5e-4, as in
    ``tests/test_torch_mesh_train.py`` (fp32 throughout)."""
    monkeypatch.setattr(port_workflow, "run_prediction",
                        functools.partial(port_workflow.run_prediction, compute_dtype=torch.float32))
    # few CPU threads, here and in the spawned ranks: the tests run in
    # several worker processes at once, whose thread pools oversubscribe
    # the cores
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    request.addfinalizer(lambda: torch.set_num_threads(threads))
    import bootstrapper_torch.workflows.train as port_train

    monkeypatch.setattr(port_train, "run_training", functools.partial(port_train.run_training, compute_dtype=torch.float32))
    if case == "sharded_batch":
        monkeypatch.setenv("BS_ZSTREAM", "0")  # the batch of tiles, not lockstep streams
    two, one = (_multi_device_run(rounds, tmp_path, case, dev) for dev in ("cpu,cpu", "cpu"))
    if case == "mesh":
        (p2, loss2), (p1, loss1) = two, one
        assert loss2 == pytest.approx(loss1, abs=1e-5)
        assert sorted(p2) == sorted(p1)
        for k in p1:
            np.testing.assert_allclose(p2[k], p1[k], rtol=0, atol=5e-4)
        return
    assert two.shape == one.shape == (3, 24, 96, 96)
    if case == "sharded_batch":
        np.testing.assert_array_equal(two, one)
        return
    # the volume's one tile splits in two along the axis of least halo:
    # apart only within 4 voxels of the seam
    from bootstrapper_torch.predict.scan import auto_shape_increase
    from bootstrapper_torch.predict.spatial import pick_shard_axis

    nc = json.loads((rounds["port"]["root"] / "round_1/setups/3d_affs/net_config.json").read_text())
    inc = auto_shape_increase(nc, (24, 96, 96))
    in_tile = [a + b for a, b in zip(nc["input_shape"], inc)]
    out_tile = [a + b for a, b in zip(nc["output_shape"], inc)]
    assert out_tile == [24, 96, 96]
    axis = pick_shard_axis(out_tile, [(i - o) // 2 for i, o in zip(in_tile, out_tile)], 2,
                           Model(nc).unet_config, in_tile)
    band = np.zeros(out_tile[axis], bool)
    band[out_tile[axis] // 2 - 4 : out_tile[axis] // 2 + 4] = True
    diff = np.moveaxis(np.abs(two.astype(int) - one.astype(int)), 1 + axis, 0)
    assert diff[~band].max() == 0 and diff.max() <= 3


def test_entry_points_refuse_a_missing_gpu(rounds):
    """Without ``--device cpu`` the device is ``cuda``: on a host without a
    GPU the command fails as ``resolve_device`` does."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device runs")
    res = CliRunner().invoke(tcli, ["predict", str(rounds["port"]["root"] / "round_1/02_predict.toml")])
    assert isinstance(res.exception, RuntimeError) and "no CUDA device" in str(res.exception)


def test_doctor_prints_one_json_line(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "bootstrapper_torch", "doctor"],
        capture_output=True, text=True, timeout=120, cwd=ROOT,
    )
    lines = proc.stdout.strip().splitlines()
    info = json.loads(lines[-1])
    assert len(lines) == 1
    for key in ("networkx", "click", "imageio", "zstandard"):
        assert info[key] is True, key
    assert proc.returncode == (0 if info["cuda_available"] and info["nvcc"] else 1)
