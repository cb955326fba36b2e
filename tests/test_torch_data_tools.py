"""Data intake in the port against the JAX package, on the CPU: each
``utils`` command and ``prepare volumes`` through both command lines on
the same inputs (written by the JAX package as zstd Zarr, or as a TIFF
stack), whose outputs must be bit-equal; ``convert_ckpt`` on a synthetic
reference state dict (built as ``tests/test_convert_torch.py`` builds it),
whose npz files must hold the same arrays and load into equal parameters;
``download_ckpts``; and ``utils/profiling.py:torch_trace`` as
``tests/test_profiling.py`` asks of the JAX package's trace."""

import json
import os

import imageio.v3 as iio
import jax
import numpy as np
import pytest
import torch
from click.testing import CliRunner

from bootstrapper_torch.cli import cli as tcli
from bootstrapper_torch.core import arrays as A
from bootstrapper_torch.models import Model, load_checkpoint, load_params
from bootstrapper_torch.models.weights import params_from_jax
from bootstrapper_torch.models.zoo import write_net_config
from bootstrapper_torch.utils import tomlio
from bootstrapper_torch.utils.profiling import torch_trace
from bootstrapper_tpu.cli import cli as jcli
from bootstrapper_tpu.core import arrays as J
from bootstrapper_tpu.models.convert_torch import load_torch_state_dict, torch_to_params
from bootstrapper_tpu.models.model import Model as JModel

SHAPE = (6, 40, 40)
VOXEL = (40, 4, 4)


def invoke(pkg: str, args):
    res = CliRunner().invoke(jcli if pkg == "jax" else tcli, args, catch_exceptions=False)
    assert res.exit_code == 0, res.output
    return res


def _inputs(root) -> dict:
    """The same inputs for each package, written by the JAX package: raw
    (noise in a box, zeros around it), labels (four ids and background),
    and the raw as a TIFF stack."""
    rng = np.random.default_rng(0)
    raw = np.zeros(SHAPE, np.uint8)
    raw[1:5, 6:30, 9:33] = rng.integers(1, 255, (4, 24, 24), dtype=np.uint8)
    labels = np.zeros(SHAPE, np.uint64)
    labels[:, :20, :20], labels[:, :20, 20:], labels[:, 20:36, :20], labels[:, 20:36, 20:] = 1, 2, 3, 4
    out = {}
    for name, data in (("raw", raw), ("labels", labels)):
        path = str(root / "in.zarr" / name)
        ds = J.prepare_ds(path, SHAPE, (0, 0, 0), VOXEL, data.dtype)
        ds[ds.roi] = data
        out[name] = path
    out["tif"] = str(root / "raw.tif")
    iio.imwrite(out["tif"], (raw.astype(np.uint16) * 3))
    return out


# each case: its arguments and the datasets it writes (under <out>)
UTILS = {
    "bbox": (["bbox", "<raw>", "<out>/c", "-p", "1"], ["c"]),
    "convert": (["convert", "<tif>", "<out>/raw", "-vs", "40", "4", "4", "-d", "uint8"], ["raw"]),
    "mask_raw": (["mask", "<raw>", "<out>/m", "-m", "raw", "-n", "1"], ["m"]),
    "mask_obj": (["mask", "<labels>", "<out>/m", "-m", "obj", "-n", "1"], ["m"]),
    "scale_pyramid_raw": (["scale-pyramid", "<raw>", "-s", "2", "--image"], ["<raw>/s0", "<raw>/s1", "<raw>/s2"]),
    "scale_pyramid_labels": (
        ["scale-pyramid", "<labels>", "-s", "2", "-f", "1", "2", "2", "--labels"],
        ["<labels>/s0", "<labels>/s1", "<labels>/s2"],
    ),
    "clahe": (["clahe", "<raw>", "<out>/h", "--clip-limit", "0.02", "-n", "1"], ["h"]),
    "merge": (["merge", "<labels>", "<out>/mg", "-p", "1,2", "-p", "2,4", "-n", "1"], ["mg"]),
}


def _fill(arg: str, inputs: dict, out: str) -> str:
    for k, v in inputs.items():
        arg = arg.replace(f"<{k}>", v)
    return arg.replace("<out>", out)


def _assert_same_array(got: str, want: str):
    g, w = A.open_ds(got), A.open_ds(want)
    assert (g.roi, g.voxel_size, g.dtype, g.shape) == (w.roi, w.voxel_size, w.dtype, w.shape)
    np.testing.assert_array_equal(g.to_ndarray(), w.to_ndarray())


@pytest.mark.parametrize("case", sorted(UTILS))
def test_utils_command_matches_jax(tmp_path, case):
    args, written = UTILS[case]
    paths = {}
    for pkg in ("jax", "port"):
        inputs = _inputs(tmp_path / pkg)
        out = str(tmp_path / pkg / "out.zarr")
        invoke(pkg, ["utils"] + [_fill(a, inputs, out) for a in args])
        paths[pkg] = [
            _fill(w, inputs, out) if w.startswith("<") else os.path.join(out, w) for w in written
        ]
    for got, want in zip(paths["port"], paths["jax"]):
        _assert_same_array(got, want)


@pytest.mark.parametrize("raw_as", ["zarr", "tif"])
def test_prepare_volumes_matches_jax(tmp_path, raw_as):
    tomls = {}
    for pkg in ("jax", "port"):
        root = tmp_path / pkg
        inputs = _inputs(root)
        container = str(root / "out.zarr")
        toml = str(root / "volumes.toml")
        invoke(pkg, [
            "prepare", "volumes", "vol", inputs["raw" if raw_as == "zarr" else "tif"],
            "--labels", inputs["labels"], "-o", container, "-vs", *map(str, VOXEL),
            "--make-masks", "-a", toml,
        ])
        text = json.dumps(tomlio.load(toml)).replace(str(root), "<root>")
        tomls[pkg] = (json.loads(text), root)
    (port, proot), (want, jroot) = tomls["port"], tomls["jax"]
    assert port == want
    vol = port["volumes"]["vol"]
    assert {"raw_dataset", "labels_dataset", "labels_mask_dataset"} <= set(vol)
    for key in ("raw_dataset", "labels_dataset", "labels_mask_dataset"):
        _assert_same_array(vol[key].replace("<root>", str(proot)), vol[key].replace("<root>", str(jroot)))


def _tiny_setup(setup_dir: str) -> dict:
    """``tests/test_convert_torch.py``'s narrow 3d_affs net as a setup."""
    write_net_config("3d_affs", setup_dir)
    path = os.path.join(setup_dir, "net_config.json")
    with open(path) as f:
        nc = json.load(f)
    nc.update(
        num_fmaps=2, fmap_inc_factor=2, input_shape=[12, 48, 48], output_shape=[4, 8, 8],
        downsample_factors=[[1, 2, 2]] * 2,
        kernel_size_down=[[[1, 3, 3], [1, 3, 3]], [[3, 3, 3], [3, 3, 3]], [[3, 3, 3], [3, 3, 3]]],
        kernel_size_up=[[[1, 3, 3], [1, 3, 3]], [[1, 3, 3], [1, 3, 3]]],
    )
    nc["outputs"] = {"3d_affs": {"dtype": "uint8", "dims": 3, "neighborhood": [[-1, 0, 0], [0, -1, 0], [0, 0, -1]]}}
    with open(path, "w") as f:
        json.dump(nc, f)
    return nc


def _reference_state(model) -> dict:
    """A torch state dict shaped like the reference module tree, as a
    Lightning checkpoint (``model.`` prefixes under ``state_dict``)."""
    from tests.test_convert_torch import _fake_reference_state

    return {"state_dict": {f"model.{k}": v for k, v in _fake_reference_state(model).items()}}


def test_convert_ckpt_matches_jax(tmp_path):
    setup = str(tmp_path / "setup")
    _tiny_setup(setup)
    ckpt = str(tmp_path / "reference.ckpt")
    torch.save(_reference_state(JModel.from_setup(setup)), ckpt)
    outs = {}
    for pkg in ("jax", "port"):
        outs[pkg] = str(tmp_path / f"{pkg}_model_checkpoint_0")
        invoke(pkg, ["utils", "convert-ckpt", ckpt, setup, outs[pkg]])
    with np.load(outs["port"]) as got, np.load(outs["jax"]) as want:
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the port's model from its file holds what params_from_jax makes of the
    # JAX package's conversion
    jparams = torch_to_params(load_torch_state_dict(ckpt), JModel.from_setup(setup))
    model = load_params(Model.from_setup(setup), load_checkpoint(outs["port"]))
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)


def test_download_ckpts_matches_jax(tmp_path):
    files = {}
    for pkg in ("jax", "port"):
        setup = tmp_path / pkg
        invoke(pkg, ["utils", "download-ckpts", "3d_affs_from_2d_lsd", str(setup)])
        files[pkg] = {n: open(setup / n, "rb").read() for n in os.listdir(setup)}
    assert files["port"] == files["jax"]
    assert any(n.startswith("model_checkpoint") for n in files["port"])


def test_torch_trace_noop_without_env(tmp_path, monkeypatch):
    monkeypatch.delenv("BS_PROFILE", raising=False)
    monkeypatch.chdir(tmp_path)
    with torch_trace("t"):
        torch.ones(8, 8).sum()
    assert os.listdir(tmp_path) == []


def test_torch_trace_writes_when_enabled(tmp_path, monkeypatch):
    monkeypatch.setenv("BS_PROFILE", str(tmp_path))
    with torch_trace("unit"):
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    with open(tmp_path / "unit" / "trace.json") as f:
        trace = json.load(f)
    assert any("mm" in e.get("name", "") for e in trace["traceEvents"])
