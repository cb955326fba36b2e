"""The proofreading cell at test size on the CPU: a sound run is correct,
the program's SAM agrees with the plain reference, and runs whose timed
path is broken underneath, or the reference in bf16 in the program's
place, come out not correct."""

import numpy as np
import pytest
import torch

from tiny import TINY_SAM, drive, make_root, tiny_sam_config

from bmk import cli
from bmk.data import seed32
from bmk.sam_weights import make_sam_weights
from bmk.spec import Bench

CELL = "s.proofread"


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(str(tmp_path_factory.mktemp("proofread")))


@pytest.fixture(autouse=True)
def tiny_preset(monkeypatch):
    """The program infers a checkpoint's variant from its encoder's width:
    the test width is registered as a preset."""
    from bootstrapper_torch.models import sam as S

    monkeypatch.setitem(S.PRESETS, "tiny_test", tiny_sam_config())


def test_sound_run_is_correct(root):
    rc, result, err = drive(root, CELL, seconds=0.5)
    assert rc == 0, err[-3000:]
    assert result["correct"], err[-3000:]
    # at least the check sections, whole sections of 4 clicks
    assert result["attempted"] % 4 == 0 and result["attempted"] >= 8 and result["failed"] == 0
    assert set(result["metrics"]) == {"section_ms", "first_mask_ms", "setup_s"}
    # the first click of a section embeds it: it takes part of the section
    assert 0 < result["metrics"]["first_mask_ms"]["value"] < result["metrics"]["section_ms"]["value"]


def test_traced_run_reads_its_host_metrics(root):
    rc, result, err = drive(root, CELL, seconds=0.3, trace=1)
    assert rc == 0, err[-3000:]
    assert result["correct"]
    # the device-trace readers find no device work on the CPU; the clicks'
    # host time is read from the harness's host spans
    assert set(result["metrics"]) == {"mfu_pct.proofread", "click_ms.proofread"}
    assert result["metrics"]["click_ms.proofread"]["value"] > 0
    assert 0 < result["metrics"]["mfu_pct.proofread"]["value"] < 100


def test_program_agrees_with_the_reference():
    """The program's ``SamPredictor`` against ``reference/sam.py`` on the
    same seeded weights, a 150^2 section (downscaled to 128^2, so the
    antialiasing resize runs) and one click."""
    from bootstrapper_torch.models.sam import SamPredictor, sam_from_state_dict

    from reference.sam import SamReference, precision

    sd = make_sam_weights(TINY_SAM, seed32(5, 8), "cpu")
    rng = np.random.default_rng(5)
    section = rng.integers(0, 256, (150, 150)).astype(np.uint8)
    pred = SamPredictor(sam_from_state_dict(sd, device="cpu"), device="cpu").set_image(section)
    logits, iou = pred.predict([[40, 90]], [1], return_logits=True)
    ref = SamReference(sd, TINY_SAM)
    with torch.no_grad(), precision(tf32=False):
        emb = ref.embed(section, "cpu")
        _, want_iou, want = ref.predict(emb, (40, 90), section.shape)
    want = want.numpy()
    got_emb = pred._embedding[0]
    assert float((got_emb - emb[0].permute(1, 2, 0)).abs().max() / emb.abs().max()) < 1e-5
    assert np.abs(logits - want).max() / np.abs(want).max() < 1e-5
    assert np.abs(iou - want_iou.numpy()).max() < 1e-5


def rel_pos_dropped_from_the_global_block(monkeypatch):
    from bootstrapper_torch.models import sam as S

    real = S.get_rel_pos

    def get_rel_pos(q_size, k_size, rel_pos):
        got = real(q_size, k_size, rel_pos)
        grid = TINY_SAM["img_size"] // TINY_SAM["patch_size"]
        return torch.zeros_like(got) if q_size == grid else got

    monkeypatch.setattr(S, "get_rel_pos", get_rel_pos)


def encoder_in_bf16(monkeypatch):
    from bootstrapper_torch.models import sam as S

    real = S.ImageEncoderViT.forward

    def forward(self, x):
        with torch.autocast("cpu", dtype=torch.bfloat16):
            return real(self, x).float()

    monkeypatch.setattr(S.ImageEncoderViT, "forward", forward)


def unpartition_keeps_its_padding(monkeypatch):
    """The window unpartition crops the wrong end: it keeps the padding
    and drops as many rows and columns of tokens."""
    from bootstrapper_torch.models import sam as S

    def window_unpartition(x, win, hw_pad, hw):
        hp, wp = hw_pad
        h, w = hw
        b = x.shape[0] // (hp // win * (wp // win))
        x = x.reshape(b, hp // win, wp // win, win, win, -1).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(b, hp, wp, -1)[:, hp - h :, wp - w :]

    monkeypatch.setattr(S, "window_unpartition", window_unpartition)


def masks_altered_where_produced(monkeypatch):
    """The mask decoder's logits with one value in 97 negated."""
    from bootstrapper_torch.models import sam as S

    real = S.MaskDecoder.forward

    def forward(self, *args):
        masks, iou = real(self, *args)
        flat = masks.view(-1)
        flat[::97] = -flat[::97]
        return masks, iou

    monkeypatch.setattr(S.MaskDecoder, "forward", forward)


def embedding_left_from_the_first_section(monkeypatch):
    """``set_image`` embeds the first section it is given and keeps that
    embedding for every later one."""
    from bootstrapper_torch.models import sam as S

    real = S.SamPredictor.set_image

    def set_image(self, image):
        if self._embedding is None:
            return real(self, image)
        return self

    monkeypatch.setattr(S.SamPredictor, "set_image", set_image)


def encoder_in_bf16_after_the_warm_sections(monkeypatch):
    """The encoder in bf16 from the third section it embeds on: set-up's
    warm sections run sound, the window's do not."""
    from bootstrapper_torch.models import sam as S

    real = S.ImageEncoderViT.forward
    calls = []

    def forward(self, x):
        calls.append(1)
        if len(calls) <= 2:
            return real(self, x)
        with torch.autocast("cpu", dtype=torch.bfloat16):
            return real(self, x).float()

    monkeypatch.setattr(S.ImageEncoderViT, "forward", forward)


def mask_of_least_iou_taken(monkeypatch):
    """The session writes the multimask output of lowest predicted IOU."""
    from bootstrapper_torch.proofread import ProofreadSession

    real = ProofreadSession._sam_segment_from_point

    def pick(self, p_vox):
        predict = self._sam.predict

        def worst(points, labels, **kw):
            masks, iou = predict(points, labels, **kw)
            return masks, -iou

        self._sam.predict = worst
        try:
            return real(self, p_vox)
        finally:
            self._sam.predict = predict

    monkeypatch.setattr(ProofreadSession, "_sam_segment_from_point", pick)


def label_written_over_earlier_segments(monkeypatch):
    """The label write overwrites what earlier clicks on the section wrote."""
    from bootstrapper_torch.core.geometry import Coordinate, Roi
    from bootstrapper_torch.proofread import ProofreadSession

    def write(self, p_vox):
        z = int(p_vox[0])
        if self._sam_section != z:
            vs = self.raw.voxel_size
            roi = Roi(self.raw.offset + Coordinate((z, 0, 0)) * vs, Coordinate((1, *self.raw.spatial_shape[1:])) * vs)
            self._sam.set_image(self.raw.to_ndarray(roi)[0])
            self._sam_section = z
        masks, iou = self._sam.predict([[int(p_vox[2]), int(p_vox[1])]], [1])
        self.labels[z][masks[1:][int(np.argmax(iou[1:]))]] = self.next_id
        self.next_id += 1
        return self.next_id - 1

    monkeypatch.setattr(ProofreadSession, "_sam_segment_from_point", write)


@pytest.mark.parametrize("fault", [rel_pos_dropped_from_the_global_block, encoder_in_bf16,
                                   unpartition_keeps_its_padding, masks_altered_where_produced,
                                   embedding_left_from_the_first_section, encoder_in_bf16_after_the_warm_sections,
                                   mask_of_least_iou_taken, label_written_over_earlier_segments])
def test_a_broken_program_is_not_correct(root, monkeypatch, fault):
    fault(monkeypatch)
    rc, result, err = drive(root, CELL, seconds=0.2)
    assert rc == 0, err[-3000:]
    assert not result["correct"]


def test_a_click_that_raises_ends_the_run(root, monkeypatch):
    """A click that raises is no failed click that the run counts and goes
    past: the run ends with the error and prints no result."""
    from bootstrapper_torch.models import sam as S

    real = S.SamPredictor.predict
    calls = []

    def predict(self, *args, **kw):
        calls.append(1)
        if len(calls) == 11:
            raise RuntimeError("the decoder broke")
        return real(self, *args, **kw)

    monkeypatch.setattr(S.SamPredictor, "predict", predict)
    with pytest.raises(RuntimeError, match="the decoder broke"):
        drive(root, CELL, seconds=0.2)


def test_clicks_land_inside_objects():
    """Every click of a plan lies on a labelled object, at least MIN_DEPTH
    pixels from any pixel of another id, and a section's clicks hit
    distinct objects where it has enough."""
    from bmk.data import voronoi_sample
    from bmk.proofread import MIN_DEPTH, Plan, object_points

    labels = voronoi_sample((6, 150, 150), 67, 11, "cpu")["labels"]
    plan = Plan({"volume": [6, 150, 150], "clicks_per_section": 4}, 11, object_points(labels, "cpu"))
    for _ in range(6):
        z, points = plan.visit()
        ids = [int(labels[z, y, x]) for y, x in points]
        assert all(ids) and len(set(ids)) == len(ids)
        for (y, x), i in zip(points, ids):
            r = MIN_DEPTH - 1
            assert (labels[z, y - r : y + r + 1, x - r : x + r + 1] == i).all()


def test_reference_bf16_control(root):
    """The reference in bf16, one precision below the configuration's fp32,
    in the program's place."""
    rc, result, err = drive(root, CELL, control="reference_bf16")
    assert rc == 0, err[-3000:]
    assert not result["correct"]
    assert result["metrics"] == {}


@pytest.mark.parametrize("kind", ["nothing", "events", "Predict", "bmk.train"])
def test_a_kind_with_no_runner(root, monkeypatch, kind):
    """A traffic of a kind with no ``bmk/<kind>.py`` exposing ``run``:
    ``run_cell`` refuses it with the message it always gave."""
    monkeypatch.setattr(Bench, "traffic", lambda self, name: {"kind": kind})
    args = cli.parse(["--workload", CELL, "--seed", "1", "--seconds", "1", "--device", "cpu"])
    with pytest.raises(ValueError, match=f"traffic 'tiny_proofread' is of no kind the harness drives: '{kind}'"):
        cli.run_cell(Bench(root), args, 0.0)


@pytest.mark.parametrize("kind", ["predict", "train", "proofread"])
def test_each_kind_finds_its_runner(kind):
    assert cli.runner_of("x", kind).__name__ == f"bmk.{kind}"


def test_the_cell_and_its_configuration_are_found_by_name():
    from tiny import REPO

    bench = Bench(REPO)
    cell = bench.cell("sam_vit_h.proofread_sections")
    cfg = bench.config(cell["config"])
    assert bench.traffic(cell["traffic"])["kind"] == "proofread"
    assert (cfg["encoder_dim"], cfg["encoder_depth"], cfg["encoder_heads"]) == (1280, 32, 16)
    assert set(bench.limits(cell["name"])["numbers"]) == {"embed_gap", "logit_gap", "iou_gap", "label_flip_share"}
