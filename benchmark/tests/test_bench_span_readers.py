"""The readers of the program's spans (``bmk/spans.py``) on hand-written
traces, and the spans in the trace of a tiny cell's ``--trace 1`` run."""

import pytest

from tiny import REPO, drive, make_root

from bmk import cli
from bmk.spec import Bench


def ev(name, dev, ts, dur, corr=0, link=0, user=False):
    return {"name": name, "dev": dev, "ts": ts, "dur": dur, "corr": corr, "link": link, "user": user}


def span(name, ts, dur):
    return ev(name, "cpu", ts, dur, user=True)


def predict_trace():
    """Two steps: read waits of 50, 20 and 10 us (the last takes the
    reader's end), dispatches of 30 and 40, writes of 100 and 150; a
    device-side range named like the write span."""
    return [
        span("bmk.window", 0, 1000),
        span("bmk.pass", 0, 1000),
        span("bs.predict.read_wait", 0, 50),
        span("bs.predict.dispatch", 50, 30),
        ev("aten::copy_", "cpu", 55, 5, corr=1),
        ev("Memcpy HtoD (Pinned -> Device)", "cuda", 100, 100, link=1),
        span("bs.predict.read_wait", 80, 20),
        span("bs.predict.dispatch", 100, 40),
        span("bs.predict.drain", 140, 260),
        span("bs.predict.device_wait", 140, 160),
        span("bs.predict.write", 300, 100),
        span("bs.predict.drain", 400, 200),
        span("bs.predict.device_wait", 400, 50),
        span("bs.predict.write", 450, 150),
        span("bs.predict.read_wait", 600, 10),
        ev("bs.predict.write", "cuda", 0, 1000, user=True),
    ]


def train_trace():
    """Two steps.  The first's transform (290 us) launches four device
    operations, one of them after the span has ended and one from a host
    op nested in another; its step (700 us) launches four, the
    backward's by time.  The second step's transform (50) and step (200)
    launch none.  A host op outside every span, a runtime call in the
    transform whose (CUPTI) ``corr`` equals that op's id, and
    device-side ranges named like the spans, count for nothing."""
    return [
        span("bmk.window", 0, 2000),
        span("bs.train.loader_wait", 0, 10),
        span("bs.train.transform", 10, 290),
        span("bs.train.upload", 10, 40),
        ev("aten::copy_", "cpu", 20, 5, corr=11),
        ev("cudaMemcpyAsync", "cpu", 22, 2, corr=9011, link=11),
        ev("Memcpy HtoD (Pinned -> Device)", "cuda", 400, 20, corr=9011, link=11),  # after the span
        span("bs.train.augment", 50, 100),
        ev("aten::add", "cpu", 60, 5, corr=12),
        ev("elementwise_kernel<add>", "cuda", 430, 10, link=12),
        ev("aten::mul", "cpu", 70, 10, corr=13),
        ev("aten::mul_out", "cpu", 71, 8, corr=14),
        ev("cudaLaunchKernel", "cpu", 72, 2, corr=30, link=14),  # corr collides with aten::sum's id
        ev("elementwise_kernel<mul>", "cuda", 445, 5, corr=30, link=14),
        span("bs.train.targets", 150, 150),
        ev("aten::eq", "cpu", 200, 5, corr=15),
        ev("elementwise_kernel<eq>", "cuda", 450, 10, link=15),
        span("bs.train.step", 300, 700),
        span("bs.train.forward", 300, 200),
        ev("aten::convolution", "cpu", 310, 5, corr=21),
        ev("conv3d_kernel_bf16_wgmma<152>", "cuda", 500, 100, link=21),
        span("bs.train.backward", 500, 300),
        ev("autograd::engine::evaluate_function", "cpu", 510, 50, corr=22),
        ev("sm90_xmma_dgrad", "cuda", 620, 100, link=22),
        ev("aten::upsample_trilinear3d_backward", "cpu", 600, 50, corr=23),
        ev("upsample_trilinear3d_backward_out_frame", "cuda", 720, 50, link=23),
        span("bs.train.optimizer", 800, 200),
        ev("aten::_fused_adam_", "cpu", 810, 20, corr=24),
        ev("Memset (Device)", "cuda", 1000, 5, link=24),
        span("bs.train.transform", 1050, 50),
        span("bs.train.step", 1100, 200),
        ev("aten::sum", "cpu", 1500, 5, corr=30),
        ev("reduce_kernel", "cuda", 1510, 10, link=30),
        ev("Optimizer.step", "cuda", 0, 2000, user=True),
        ev("bs.train.transform", "cuda", 0, 2000, user=True),
    ]


def predict_record(trace):
    return {"kind": "predict", "trace": trace}


def train_record(trace):
    return {"kind": "train", "trace": trace, "trace_steps": 2}


CASES = [
    ("read_wait_ms.predict", predict_record(predict_trace()), (50 + 20 + 10) / 1e3 / 2),
    ("dispatch_ms.predict", predict_record(predict_trace()), (30 + 40) / 1e3 / 2),
    ("write_ms.predict", predict_record(predict_trace()), (100 + 150) / 1e3 / 2),
    ("transform_host_ms.train", train_record(train_trace()), (290 + 50) / 1e3 / 2),
    ("transform_launches.train", train_record(train_trace()), 4 / 2),
    ("step_host_ms.train", train_record(train_trace()), (700 + 200) / 1e3 / 2),
    ("step_launches.train", train_record(train_trace()), 4 / 2),
]


@pytest.mark.parametrize("metric,record,want", CASES, ids=[c[0] for c in CASES])
def test_span_reader_on_a_recorded_trace(metric, record, want):
    assert Bench(REPO).reader(metric)(record) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("metric", [c[0] for c in CASES])
def test_span_reader_finds_nothing_to_read(metric):
    """The other kind of cell, no trace, or a trace with no span of the
    program's (a program that opens none): nothing, never a 0."""
    predict = metric.endswith("predict")
    kind, other = (predict_record, train_record) if predict else (train_record, predict_record)
    trace = predict_trace() if predict else train_trace()
    read = Bench(REPO).reader(metric)
    harness_only = [e for e in trace if not e["name"].startswith("bs.") or e["dev"] == "cuda"]
    assert read(kind(None)) is None
    assert read(kind(harness_only)) is None
    assert read(other(trace)) is None
    if "launches" in metric:
        assert read(kind([e for e in trace if e["dev"] == "cpu"])) is None


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(str(tmp_path_factory.mktemp("spans")))


@pytest.mark.parametrize(
    "cell,spans,metrics",
    [
        ("a.stream", ["bs.predict.read_wait", "bs.predict.dispatch", "bs.zstream.warm", "bs.zstream.steady",
                      "bs.predict.drain", "bs.predict.device_wait", "bs.predict.write"],
         ["read_wait_ms.predict", "dispatch_ms.predict", "write_ms.predict"]),
        ("a.train", ["bs.train.loader_wait", "bs.train.transform", "bs.train.upload", "bs.train.augment",
                     "bs.train.targets", "bs.train.step", "bs.train.forward", "bs.train.backward",
                     "bs.train.optimizer"],
         ["transform_host_ms.train", "step_host_ms.train"]),
    ],
)
def test_a_traced_run_holds_the_programs_spans(root, monkeypatch, cell, spans, metrics):
    """A tiny cell at ``--trace 1`` on the CPU: its trace holds the
    program's spans on the host, and the line reports the host metrics
    read from them (the launch counts need a device)."""
    kept = {}

    def keep(*args, **kwargs):
        kept.update(cli_run_cell(*args, **kwargs))
        return kept

    cli_run_cell = cli.run_cell
    monkeypatch.setattr(cli, "run_cell", keep)
    rc, result, err = drive(root, cell, trace=1)
    assert rc == 0, err[-3000:]
    names = {e["name"] for e in kept["record"]["trace"] if e["dev"] == "cpu" and e["user"]}
    assert set(spans) <= names
    for m in metrics:
        assert result["metrics"][m]["value"] > 0, m
    assert not any("launches" in m for m in result["metrics"])
