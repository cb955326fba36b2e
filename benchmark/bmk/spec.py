"""What a run is made of, found by name: the cell in ``BENCHMARK.json``,
its configuration's file, its traffic file (``traffic/<name>.json``), its
limits (``limits/<cell>.json``) and the reader of each per-layer metric
(``metrics/<name>.py``).  Adding any of them is adding files and entries;
nothing here names one."""

from __future__ import annotations

import importlib.util
import json
import os


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


class Bench:
    """``BENCHMARK.json`` at ``root`` and the files it names, the data files
    under ``root/benchmark``."""

    def __init__(self, root: str):
        self.root = root
        self.dir = os.path.join(root, "benchmark")
        self.spec = load_json(os.path.join(root, "BENCHMARK.json"))

    def cell(self, name: str) -> dict:
        for c in self.spec["workloads"]:
            if c["name"] == name:
                return c
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return load_json(os.path.join(self.root, c["file"]))
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return load_json(os.path.join(self.dir, "traffic", f"{name}.json"))

    def limits(self, cell: str) -> dict:
        return load_json(os.path.join(self.dir, "limits", f"{cell}.json"))

    def metrics_for(self, cell: str, section: str) -> list:
        """The metrics of ``section`` (``end_to_end`` or ``per_layer``) the
        cell reports: those without ``workloads``, and those listing it."""
        return [m for m in self.spec[section] if "workloads" not in m or cell in m["workloads"]]

    def reader(self, metric: str):
        """``metrics/<metric>.py``'s ``read(record)``."""
        path = os.path.join(self.dir, "metrics", f"{metric}.py")
        mod_spec = importlib.util.spec_from_file_location(f"bmk_metric_{len(metric)}_{abs(hash(metric))}", path)
        mod = importlib.util.module_from_spec(mod_spec)
        mod_spec.loader.exec_module(mod)
        return mod.read
