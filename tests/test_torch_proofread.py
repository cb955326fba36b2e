"""The port's proofreading session, its ``proofread`` and ``view``
commands and its pure UI and view-spec functions against the JAX
package's, on the CPU, over the same Zarr volumes.

The session's growth is host code in both packages (seeded watershed on
the affinities, scipy labelling), and its SAM route runs the port's SAM on
the CPU beside the JAX package's (``tests/test_torch_sam.py``'s tiny
config, registered as a preset in both for the session's width
inference): labels and written Zarrs are equal, command-line output line
for line.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch
from _sam_torch_mirror import SamMirror
from click.testing import CliRunner

from bootstrapper_torch import proofread_ui as UI
from bootstrapper_torch.cli import main as tmain
from bootstrapper_torch.cli import view_spec as VS
from bootstrapper_torch.cli import viewer as TV
from bootstrapper_torch.core import arrays as A
from bootstrapper_torch.models import sam as S
from bootstrapper_torch.ops.affinities import seg_to_affs
from bootstrapper_torch.proofread import ProofreadSession
from bootstrapper_tpu import proofread_ui as JUI
from bootstrapper_tpu.cli import main as jmain
from bootstrapper_tpu.cli import view_spec as JVS
from bootstrapper_tpu.cli import viewer as JV
from bootstrapper_tpu.core.arrays import open_ds as jax_open_ds
from bootstrapper_tpu.models import sam as JS
from bootstrapper_tpu.proofread import ProofreadSession as JSession

NBH = [[-1, 0, 0], [0, -1, 0], [0, 0, -1]]


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """This module's torch work on 2 CPU thread(s) (several test workers
    share the cores); restored after the module."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def volume(tmp_path):
    """Two objects split in y, a speck of a third; raw, uint8 affinities."""
    shape = (4, 64, 64)
    gt = np.zeros(shape, np.int64)
    gt[:, :32] = 1
    gt[:, 32:] = 2
    gt[:, 40:44, 50:54] = 3
    rng = np.random.default_rng(0)
    raw = A.prepare_ds(str(tmp_path / "p.zarr/raw"), shape, (0, 0, 0), (40, 4, 4), np.uint8)
    img = rng.integers(196, 204, shape, dtype=np.uint8)
    img[:, 31:33] = 10  # a dark boundary between the objects
    raw[raw.roi] = img
    affs = (np.asarray(seg_to_affs(torch.from_numpy(gt), NBH)) * 255).astype(np.uint8)
    ads = A.prepare_ds(str(tmp_path / "p.zarr/affs"), affs.shape, (0, 0, 0), (40, 4, 4), np.uint8)
    ads[ads.roi] = affs
    return tmp_path, raw.path, ads.path


def _sessions(volume, affs=True, **kw):
    _, raw, ads = volume
    port = ProofreadSession(A.open_ds(raw), A.open_ds(ads) if affs else None, device="cpu", **kw)
    jax_ = JSession(jax_open_ds(raw), jax_open_ds(ads) if affs else None, **kw)
    return port, jax_


def _both(sessions, op, *args, **kw):
    got = [getattr(s, op)(*args, **kw) for s in sessions]
    assert got[0] == got[1], (op, got)
    np.testing.assert_array_equal(sessions[0].labels, sessions[1].labels)
    assert sessions[0].next_id == sessions[1].next_id
    return got[0]


@pytest.mark.parametrize("affs", [True, False], ids=["affinities", "raw_gradients"])
def test_session_operations_match_jax(volume, affs):
    """Every operation, in turn, on both sessions: equal ids, labels and
    written Zarrs."""
    tmp, _, _ = volume
    sessions = _sessions(volume, affs)
    a = _both(sessions, "segment_from_point", (80, 40, 120))
    b = _both(sessions, "segment_from_point", (80, 200, 200), radius=32)
    c = _both(sessions, "segment_from_point", (120, 160, 40), two_d=True)
    assert a > 0 and b > 0
    _both(sessions, "segment_from_point", (0, 126, 10))  # on a boundary with affinities: 0
    merged = _both(sessions, "merge", [a, b])
    _both(sessions, "unmerge", merged)
    _both(sessions, "omit", c)
    for s in sessions:
        s.labels[0, 0, 0] = 777
        s.next_id = 800
    _both(sessions, "filter_small", 5)
    _both(sessions, "delete", a)
    written = [s.write(str(tmp / name)) for s, name in zip(sessions, ("port.zarr", "jax.zarr"))]
    for key in ("labels", "mask"):
        got, want = A.open_ds(written[0][key]), jax_open_ds(written[1][key])
        assert got.dtype == want.dtype and tuple(got.voxel_size) == tuple(want.voxel_size)
        np.testing.assert_array_equal(got.to_ndarray(), want.to_ndarray())


@pytest.fixture
def tiny_sam(tmp_path, monkeypatch):
    """A random official-key checkpoint of the tiny config, registered as a
    preset in both packages so that their loaders infer it by width."""
    from test_torch_sam import CFG, PCFG, _mirror

    path = str(tmp_path / "sam_tiny.pth")
    torch.save(_mirror().state_dict(), path)
    monkeypatch.setitem(S.PRESETS, "tiny", PCFG)
    monkeypatch.setitem(JS.PRESETS, "tiny", CFG)
    return path


def test_sam_session_matches_jax(volume, tiny_sam):
    """With a checkpoint, a point prompt runs SAM on its section (the best
    of the three multimask outputs): the port on the CPU and the JAX
    package give the same labels; a second click on the section reuses
    its embedding."""
    sessions = _sessions(volume, sam_checkpoint=tiny_sam)
    assert all(s._sam is not None for s in sessions)
    _both(sessions, "segment_from_point", (80, 100, 120))
    _both(sessions, "segment_from_point", (80, 20, 30))
    assert sessions[0]._sam_section == 2
    _both(sessions, "segment_from_point", (40, 180, 200))
    assert (sessions[0].labels > 0).any()


def test_sam_session_from_environment(volume, tiny_sam, monkeypatch):
    monkeypatch.setenv("BS_SAM_CHECKPOINT", tiny_sam)
    port, _ = _sessions(volume)
    assert port._sam is not None and port._sam.device == torch.device("cpu")
    monkeypatch.setenv("BS_SAM_CHECKPOINT", tiny_sam + ".missing")
    assert _sessions(volume)[0]._sam is None


SCRIPT = "point 80 40 120\npoint 80 200 200\nmerge 1 2\nunmerge 1\nomit 3\nfilter 1\nbogus\nmerge x\nwrite {out}\nquit\n"


def _cli_outputs(volume, name, extra, monkeypatch=None):
    tmp, raw, ads = volume
    outs = {}
    for pkg, cli, prefix in (("port", tmain.cli, ["--device", "cpu"]), ("jax", jmain.cli, [])):
        out = tmp / f"{name}_{pkg}.zarr"
        script = tmp / f"{name}_{pkg}.txt"
        script.write_text(SCRIPT.format(out=out))
        res = CliRunner().invoke(
            cli, prefix + ["proofread", raw, "-a", ads, "--script", str(script), *extra], catch_exceptions=False
        )
        assert res.exit_code == 0, res.output
        outs[pkg] = (res.output.replace(str(out), "OUT"), str(out))
    return outs


@pytest.mark.parametrize("sam", [False, True], ids=["affinities", "sam"])
def test_cli_proofread_script_matches_jax(volume, request, sam):
    """``proofread --script`` through both command lines: the same lines
    printed and the same Zarrs written."""
    extra = ["--sam-checkpoint", request.getfixturevalue("tiny_sam")] if sam else []
    outs = _cli_outputs(volume, "sam" if sam else "affs", extra)
    assert outs["port"][0] == outs["jax"][0]
    assert ("(SAM)" in outs["port"][0]) == sam and "unknown command: bogus" in outs["port"][0]
    for ds in ("proofread/labels", "proofread/mask"):
        got = A.open_ds(os.path.join(outs["port"][1], ds)).to_ndarray()
        np.testing.assert_array_equal(got, jax_open_ds(os.path.join(outs["jax"][1], ds)).to_ndarray())


def test_cli_proofread_needs_a_device(volume):
    """Without ``--device cpu`` the session asks for the card: no GPU here,
    so the command fails rather than run SAM elsewhere."""
    tmp, raw, _ = volume
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    res = CliRunner().invoke(tmain.cli, ["proofread", raw, "--script", os.devnull])
    assert res.exit_code != 0 and "CUDA" in repr(res.exception)


def _view(cli, args):
    res = CliRunner().invoke(cli, ["view", *args], catch_exceptions=False)
    assert res.exit_code == 0, res.output
    return res.output


def test_cli_view_matches_jax(volume):
    """``view`` without neuroglancer: the text summary of every dataset of a
    container, and ``--snapshot``'s layer plan, line for line."""
    tmp, raw, _ = volume
    outs = _cli_outputs(volume, "view", [])
    container = outs["port"][1]
    assert _view(tmain.cli, [container]) == _view(jmain.cli, [container])
    assert _view(tmain.cli, [os.path.dirname(raw)]) == _view(jmain.cli, [os.path.dirname(raw)])
    snap = str(tmp / "batch_10.zarr")
    for name, shape in [("raw", (2, 3, 64, 64)), ("pred_affs", (2, 6, 1, 64, 64)), ("gt_labels", (2, 1, 1, 64, 64))]:
        ds = A.prepare_ds(os.path.join(snap, name), shape, (0,) * 3, (8, 8, 8), np.float32)
        ds[ds.roi] = np.random.default_rng(1).random(shape, dtype=np.float32)
    assert TV.snapshot_metadata(snap) == JV.snapshot_metadata(snap)
    assert _view(tmain.cli, ["--snapshot", snap]) == _view(jmain.cli, ["--snapshot", snap])


SNAPSHOTS = [
    {"raw": ((2, 1, 12, 64, 64), [50, 8, 8], [0, 0, 0]), "gt_affs": ((2, 9, 12, 64, 64), [50, 8, 8], [0, 0, 0]),
     "pred_affs": ((2, 9, 12, 64, 64), [50, 8, 8], [0, 0, 0]), "gt_labels": ((2, 1, 12, 64, 64), [50, 8, 8], [0, 0, 0])},
    {"raw": ((2, 3, 64, 64), [50, 8, 8], [100, 16, 24]), "pred_affs": ((2, 6, 1, 64, 64), [50, 8, 8], [50, 8, 8]),
     "gt_seg": ((2, 1, 1, 64, 64), [50, 8, 8], [0, 0, 0])},
    {"raw": ((12, 64, 64), [50, 8, 8], [0, 0, 0])},
    {"input": ((1, 64, 64), [8, 8], [0, 0]), "pred_lsds": ((4, 1, 64, 64), [8, 8], [16, 8])},
]


@pytest.mark.parametrize("index", range(len(SNAPSHOTS)))
def test_view_spec_matches_jax(index):
    datasets = SNAPSHOTS[index]
    assert dataclasses.asdict(VS.snapshot_view_spec(datasets)) == dataclasses.asdict(JVS.snapshot_view_spec(datasets))
    for raw_shape, first in [((2, 1, 12, 4, 4), (2, 9, 1, 4, 4)), ((2, 3, 4, 4), (2, 6, 1, 4, 4)), ((1, 4, 4), (3, 4, 4)),
                             ((3, 4, 4), (2, 4, 4)), ((4, 4), (4, 4))]:
        assert VS.detect_2d(raw_shape, first) == JVS.detect_2d(raw_shape, first)
    for name in ("raw", "pred_affs", "gt_labels", "seg"):
        for is_2d in (False, True):
            assert VS.shader_for(name, is_2d) == JVS.shader_for(name, is_2d)
            assert VS.is_segmentation(name) == JVS.is_segmentation(name)


class _Anno:
    def __init__(self, segments=None, point_a=None, point_b=None):
        self.segments, self.point_a, self.point_b = segments, point_a, point_b


def test_proofread_ui_matches_jax():
    """The UI's pure parts: layer plan, key bindings, start position,
    selected ids, the spatial mask of box annotations, patch bounds."""
    assert [dataclasses.asdict(s) for s in UI.proofread_layer_specs()] == [
        dataclasses.asdict(s) for s in JUI.proofread_layer_specs()
    ]
    assert UI.PROOFREAD_KEYBINDINGS == JUI.PROOFREAD_KEYBINDINGS and UI.ANNOTATION_COLOR == JUI.ANNOTATION_COLOR
    for shape in [(4, 64, 64), (5, 33, 17)]:
        assert UI.start_position(shape) == JUI.start_position(shape)
    annos = [_Anno([[3, 4], [5]]), _Anno([7]), _Anno([np.array([9, 3])]), _Anno(None), _Anno([])]
    assert UI.selected_ids(annos) == JUI.selected_ids(annos)
    boxes = [
        [_Anno(point_a=(40, 8, 8), point_b=(120, 40, 60))],
        [_Anno(point_a=(200, 100, 100), point_b=(-40, -8, 4)), _Anno([1])],
        [_Anno(point_a=(0, 0, 0), point_b=(0, 10, 10))],
        [_Anno([2])],
    ]
    for annos in boxes:
        got = UI.spatial_mask(annos, (4, 16, 16), (0, 0, 0), (40, 4, 4))
        want = JUI.spatial_mask(annos, (4, 16, 16), (0, 0, 0), (40, 4, 4))
        assert (got is None) == (want is None)
        if got is not None:
            np.testing.assert_array_equal(got, want)
    for pos in [(1, 10, 10), (3, 500, 2), (0, 0, 0)]:
        for got, want in zip(UI.patch_bounds(pos, (4, 600, 600)), JUI.patch_bounds(pos, (4, 600, 600))):
            np.testing.assert_array_equal(got, want)


def test_launch_viewer_imports_neuroglancer_where_needed(volume, monkeypatch):
    """Without neuroglancer installed, importing the UI works and the
    viewer raises at its first line, as the JAX package's does."""
    monkeypatch.setitem(sys.modules, "neuroglancer", None)
    port, _ = _sessions(volume)
    with pytest.raises(ImportError):
        UI.launch_viewer(port)
