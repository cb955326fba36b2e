"""Each per-layer metric's reader on a small recorded trace."""

import pytest

from tiny import REPO

from bmk import flops as F
from bmk.spec import Bench

K1_SHAPE = ((1, 18, 46, 46, 1500), (3, 3, 3, 1500, 1500))


def ev(name, dev, ts, dur, corr=0, link=0, user=False):
    return {"name": name, "dev": dev, "ts": ts, "dur": dur, "corr": corr, "link": link, "user": user}


def trace():
    """A window of 1000 us: a transform span launching one 50 us kernel, K1
    for 200 us, a library conv, an upsample and a copy."""
    return [
        ev("bmk.window", "cpu", 0, 1000, user=True),
        ev("bmk.transform", "cpu", 0, 120, user=True),
        ev("aten::add", "cpu", 10, 5, corr=7),
        ev("aten::copy_", "cpu", 600, 300, corr=8),
        ev("elementwise_kernel<add>", "cuda", 40, 50, link=7),
        ev("void conv3d_kernel_bf16_wgmma<256, 128>(Params)", "cuda", 100, 200, link=9),
        ev("sm90_xmma_fprop_implicit_gemm_bf16", "cuda", 300, 100, link=9),
        ev("upsample_trilinear3d_out_frame", "cuda", 400, 100, link=9),
        ev("Memcpy HtoD (Pinned -> Device)", "cuda", 500, 50, link=9),
        ev("Optimizer.step", "cuda", 0, 1000, user=True),  # a device-side range, no work of its own
    ]


def predict_record(**kw):
    rec = {"kind": "predict", "window_s": 4.0, "passes": 2, "least_flops_per_pass": F.PEAK_BF16,
           "computed_voxels_per_pass": 600, "volume_voxels": 300, "trace": trace(), "k1_launches": {K1_SHAPE: 3}}
    rec.update(kw)
    return rec


def train_record(**kw):
    rec = {"kind": "train", "window_s": 2.0, "steps": 5, "loader_wait_s": 0.01, "flops_per_step": F.PEAK_BF16 / 10,
           "trace": trace(), "trace_steps": 1, "k1_launches": {K1_SHAPE: 3}}
    rec.update(kw)
    return rec


K1_PCT = 100.0 * 3 * F.bound_s(*F.conv_key_work(*K1_SHAPE)) * 1e6 / 200.0


@pytest.mark.parametrize(
    "metric,record,want",
    [
        ("redundancy_x.predict", predict_record(), 2.0),
        ("mfu_pct.predict", predict_record(), 50.0),
        ("glue_share_pct.predict", predict_record(), 100.0 * (50 + 100) / (50 + 200 + 100 + 100)),
        ("k1_roofline_pct.predict", predict_record(), K1_PCT),
        ("idle_pct.predict", predict_record(), 100.0 * (1 - (50 + 450) / 1000)),
        ("loader_wait_ms.train", train_record(), 2.0),
        ("transform_device_ms.train", train_record(), 0.05),
        ("mfu_pct.train", train_record(), 25.0),
        ("k1_roofline_pct.train", train_record(), K1_PCT),
        ("idle_pct.train", train_record(), 50.0),
    ],
)
def test_reader_on_a_recorded_trace(metric, record, want):
    assert Bench(REPO).reader(metric)(record) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize(
    "metric",
    ["glue_share_pct.predict", "k1_roofline_pct.predict", "idle_pct.predict", "transform_device_ms.train",
     "k1_roofline_pct.train", "idle_pct.train"],
)
def test_reader_finds_nothing_to_read(metric):
    """No trace, a trace without device work, or the other kind of cell:
    the reader gives nothing (never a 0 share)."""
    kind = predict_record if metric.endswith("predict") else train_record
    other = train_record if metric.endswith("predict") else predict_record
    read = Bench(REPO).reader(metric)
    host_only = [e for e in trace() if e["dev"] == "cpu"]
    assert read(kind(trace=None)) is None
    assert read(kind(trace=host_only)) is None
    assert read(other()) is None


def test_every_per_layer_metric_has_a_reader():
    bench = Bench(REPO)
    for m in bench.spec["per_layer"]:
        assert callable(bench.reader(m["name"]))
