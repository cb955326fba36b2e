#!/usr/bin/env python3
"""The benchmark of bootstrapper_torch: one run of one cell on one card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the run's result as the last line of standard output (one JSON
object), and each number the correctness check compared, beside its
limit, as the last lines of standard error.  Run from the root of a
checkout; every build and kernel cache stays inside it.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

#: options of the program that would change what a run measures
PROGRAM_OPTIONS = ("BS_INT8", "BS_ZSTREAM", "BS_ZSTREAM_PLAN")


def set_environment(control=None) -> None:
    """Caches at fixed paths inside the checkout; no JAX behind a library;
    the program's options at their defaults (the control that runs the
    program's own int8 path sets its own)."""
    cache = os.path.join(HERE, "_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for name in PROGRAM_OPTIONS:
        os.environ.pop(name, None)
    if control == "program_int8":
        os.environ["BS_INT8"] = "1"


if __name__ == "__main__":
    sys.path[:0] = [HERE, ROOT]
    args_control = None
    if "--control" in sys.argv:
        args_control = sys.argv[sys.argv.index("--control") + 1]
    set_environment(args_control)
    from bmk.cli import main

    sys.exit(main(sys.argv[1:], T_START, ROOT))
