"""The run: arguments, the card, the cell's runner, its metrics, the
correctness verdict and the result line."""

from __future__ import annotations

import argparse
import importlib
import json
import re
import sys

from . import events as E
from .spec import Bench

#: top-level module names that may not be loaded when the window closes
FORBIDDEN = ("jax", "jaxlib", "flax", "bootstrapper_tpu")
#: the correctness check's controls: the reference in the program's place,
#: computed in a lower precision (the value), or the program's own int8 path
REFERENCE_CONTROLS = {"reference_int8": "int8", "reference_bf16": "bf16", "reference_tf32": "tf32"}
CONTROLS = (*REFERENCE_CONTROLS, "program_int8")


def parse(argv):
    p = argparse.ArgumentParser(prog="benchmark/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # the correctness check's controls, never part of a benchmark run: the
    # reference in int8, bf16 or with TF32 on in the program's place, or (a
    # prediction cell) the program's own int8 path
    p.add_argument("--control", choices=CONTROLS, default=None)
    # tests drive a run on the CPU; a benchmark run is on the card
    p.add_argument("--device", default="cuda", help=argparse.SUPPRESS)
    return p.parse_args(argv)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def runner_of(traffic_name: str, kind: str):
    """The module ``bmk.<kind>``, whose ``run`` drives a traffic of that
    kind."""
    runner = None
    if re.fullmatch(r"[a-z][a-z0-9_]*", kind):
        try:
            runner = importlib.import_module(f"{__package__}.{kind}")
        except ModuleNotFoundError as e:
            if e.name != f"{__package__}.{kind}":
                raise
    if not callable(getattr(runner, "run", None)):
        raise ValueError(f"traffic {traffic_name!r} is of no kind the harness drives: {kind!r}")
    return runner


def run_cell(bench: Bench, args, t_start: float) -> dict:
    """Run the cell; returns its runner's output."""
    import torch

    cell = bench.cell(args.workload)
    cfg = bench.config(cell["config"])
    traffic = bench.traffic(cell["traffic"])
    runner = runner_of(cell["traffic"], traffic["kind"])
    quantize = REFERENCE_CONTROLS.get(args.control)
    if args.control == "program_int8" and traffic["kind"] != "predict":
        raise ValueError("the program's int8 path predicts only")
    out = runner.run(cell, cfg, traffic, args.seed, args.seconds, bool(args.trace), args.device, t_start, {},
                     quantize=quantize)
    out["cell"] = cell
    out["device_name"] = torch.cuda.get_device_name(0) if args.device.startswith("cuda") else "cpu"
    return out


def metrics_of(bench: Bench, cell: str, out: dict, trace: bool) -> dict:
    if not trace:
        got = {}
        for m in bench.metrics_for(cell, "end_to_end"):
            value = out["setup_s"] if m["name"] == "setup_s" else out["e2e"].get(m["name"])
            if value is None:
                raise RuntimeError(f"{cell}: no value for its end-to-end metric {m['name']}")
            got[m["name"]] = {"value": value, "unit": m["unit"]}
        return got
    got = {}
    for m in bench.metrics_for(cell, "per_layer"):
        value = bench.reader(m["name"])(out["record"])
        if value is not None:
            got[m["name"]] = {"value": value, "unit": m["unit"]}
    return got


def verdict(limits: dict, numbers: dict) -> tuple:
    """``(correct, {name: {"value", "limit"}})``: each limited number at or
    under its limit."""
    compared = {}
    for name, limit in limits["numbers"].items():
        if name not in numbers:
            raise RuntimeError(f"the check gave no number {name!r}")
        compared[name] = {"value": numbers[name], "limit": limit}
    return all(c["value"] <= c["limit"] for c in compared.values()), compared


def main(argv, t_start: float, root: str) -> int:
    args = parse(argv)
    bench = Bench(root)
    cell = bench.cell(args.workload)
    if args.device.startswith("cuda"):
        import torch

        if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
            print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
                  f"this machine has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
    out = run_cell(bench, args, t_start)
    found = forbidden_modules()
    if found:
        print(f"modules loaded that a run may not load: {found}", file=sys.stderr)
        return 3
    # the reference in the program's place runs no window
    metrics = {} if args.control in REFERENCE_CONTROLS else metrics_of(bench, args.workload, out, bool(args.trace))
    correct, compared = verdict(bench.limits(args.workload), out["numbers"])
    device = {
        "platform": "gpu" if args.device.startswith("cuda") else "cpu",
        "kind": out["device_name"],
        "count": int(cell["chips"]),
        "memory_peak_bytes": int(out["memory_peak_bytes"]),
    }
    result = {"correct": bool(correct), "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": device}
    trace = out.get("record", {}).get("trace") if args.trace else None
    if trace is not None:
        lo, hi = E.window(trace)
        device["busy_s"] = E.busy_us(trace, lo, hi) / 1e6
        device["window_s"] = (hi - lo) / 1e6
        result["breakdown"] = {"device_ops": E.top_device_ops(trace), "idle_gaps": E.idle_gaps(trace, lo, hi)}
    result["compared"] = compared
    keys = ("window_s", "check_s", "plan", "pass_s", "chunk_s", "section_s", "first_mask_s", "setup_marks", "detail")
    info = {k: out[k] for k in keys if k in out}
    info["numbers"] = out["numbers"]
    print(json.dumps({"info": info}), file=sys.stderr)
    for name, c in compared.items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
