"""A configuration, a traffic mix, limits and a per-layer metric dropped in
as files, with entries in BENCHMARK.json, are found by name and run, with
no edit to the harness."""

import json
import os

import pytest

from tiny import drive, make_root

from bmk.spec import Bench

READER = '''"""Passes the window ran (a test's metric)."""


def read(record):
    if record.get("kind") != "predict":
        return None
    return float(record["passes"])
'''


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = make_root(str(tmp_path_factory.mktemp("dropped_in")))
    with open(os.path.join(root, "benchmark", "metrics", "passes_n.predict.py"), "w") as f:
        f.write(READER)
    spec_path = os.path.join(root, "BENCHMARK.json")
    with open(spec_path) as f:
        spec = json.load(f)
    spec["per_layer"].append({"name": "passes_n.predict", "unit": "n", "better": "higher", "source": "host_clock",
                              "layer": "predict pipeline", "moves": "predict_mvox_per_s", "workloads": ["a.stream"]})
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    return root


def test_found_by_name(root):
    bench = Bench(root)
    cell = bench.cell("a.stream")
    assert bench.config(cell["config"])["net_config"]["num_fmaps"] == 2
    assert bench.traffic(cell["traffic"])["volume"] == [20, 160, 160]
    assert set(bench.limits("a.stream")["numbers"]) == {"share_ge2", "share_ge8"}
    assert "passes_n.predict" in [m["name"] for m in bench.metrics_for("a.stream", "per_layer")]
    assert "passes_n.predict" not in [m["name"] for m in bench.metrics_for("m.sections", "per_layer")]
    assert bench.reader("passes_n.predict")({"kind": "predict", "passes": 3}) == 3.0


def test_a_dropped_in_cell_runs_and_reports_its_metric(root):
    rc, result, err = drive(root, "a.stream", trace=1)
    assert rc == 0, err[-3000:]
    assert result["correct"], err[-3000:]
    assert result["metrics"]["passes_n.predict"]["value"] >= 1
    assert result["metrics"]["redundancy_x.predict"]["unit"] == "x"
    assert list(result)[-1] == "compared"
