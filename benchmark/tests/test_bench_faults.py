"""The correctness check against runs whose timed path is broken
underneath, and against its controls, at test size on the CPU: every one
has to come out not correct, where the sound run comes out correct."""

import pytest
import torch

from tiny import drive, make_root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(str(tmp_path_factory.mktemp("faults")))


@pytest.mark.parametrize("cell", ["a.stream", "m.sections", "a.train", "m.train"])
def test_sound_run_is_correct(root, cell):
    rc, result, err = drive(root, cell)
    assert rc == 0, err[-3000:]
    assert result["correct"], err[-3000:]


def altered_quantize(real):
    """The predictors' uint8 outputs with one value in 997 raised by 64,
    where they are produced."""

    def quantize(outs):
        got = real(outs)
        for v in got.values():
            flat = v.view(-1)
            flat[::997] = flat[::997] // 2 + 64
        return got

    return quantize


@pytest.mark.parametrize("cell", ["a.stream", "m.sections"])
def test_an_answer_altered_where_it_is_produced(root, cell, monkeypatch):
    from bootstrapper_torch.predict import scan, zstream

    monkeypatch.setattr(scan, "quantize", altered_quantize(scan.quantize))
    monkeypatch.setattr(zstream, "quantize", altered_quantize(zstream.quantize))
    rc, result, err = drive(root, cell)
    assert rc == 0, err[-3000:]
    assert not result["correct"]


@pytest.mark.parametrize("cell", ["a.train", "m.train"])
def test_a_step_that_leaves_its_state_unchanged(root, cell, monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    rc, result, err = drive(root, cell)
    assert rc == 0, err[-3000:]
    assert not result["correct"]
    assert result["compared"]["step_gap"]["value"] == pytest.approx(1.0)


def test_half_the_batch_left_out(root, monkeypatch):
    """The loss of the first half of a batch of 2D sections, the mean over
    the rest."""
    from bootstrapper_torch.train import loop

    real = loop.loss_fn

    def half(model, batch, counts=None):
        n = batch["input"].shape[0] // 2
        cut = {"input": batch["input"][:n],
               "targets": {k: v[:n] for k, v in batch["targets"].items()},
               "weights": {k: v[:n] for k, v in batch["weights"].items()}}
        return real(model, cut, counts)

    monkeypatch.setattr(loop, "loss_fn", half)
    rc, result, err = drive(root, "m.train")
    assert rc == 0, err[-3000:]
    assert not result["correct"]


@pytest.mark.parametrize("cell", ["a.stream", "m.sections", "a.train", "m.train"])
def test_reference_int8_control(root, cell):
    """The reference in int8, one precision below the bf16 the setups run
    in, in the program's place."""
    rc, result, err = drive(root, cell, control="reference_int8")
    assert rc == 0, err[-3000:]
    assert not result["correct"]


@pytest.mark.parametrize("cell", ["a.stream", "m.sections"])
def test_program_int8_control(root, cell, monkeypatch):
    """The program's own int8 path (at test size on the CPU: its plain int8
    arithmetic)."""
    monkeypatch.setenv("BS_INT8", "1")
    rc, result, err = drive(root, cell, control="program_int8")
    assert rc == 0, err[-3000:]
    assert not result["correct"]
