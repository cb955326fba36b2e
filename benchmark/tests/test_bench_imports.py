"""What a run loads, and what the reference may import."""

import ast
import glob
import os
import subprocess
import sys

import pytest

from tiny import BENCH, REPO, make_root

#: compared by whole top-level module name: the port's name begins with
#: the JAX package's
JAX_SIDE = {"jax", "jaxlib", "flax", "bootstrapper_tpu"}


def imported_tops(path):
    tree = ast.parse(open(path).read())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(BENCH, "reference", "*.py"))))
def test_the_reference_imports_nothing_of_either_package(path):
    assert not imported_tops(path) & (JAX_SIDE | {"bootstrapper_torch"})


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(BENCH, "**", "*.py"), recursive=True)))
def test_no_harness_file_imports_jax_or_the_jax_package(path):
    assert not imported_tops(path) & JAX_SIDE


def test_loading_the_reference_loads_neither_package():
    code = (
        "import sys; sys.path[:0] = [%r]; import reference.unet, reference.train, reference.targets, reference.sam; "
        "print(sorted({m.split('.')[0] for m in sys.modules}))" % BENCH
    )
    tops = set(eval(subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True).stdout))
    assert not tops & (JAX_SIDE | {"bootstrapper_torch"})


def test_a_run_loads_no_jax(tmp_path):
    """A whole run in a process of its own: it checks ``sys.modules`` itself
    once the window has closed (exit code 3 where it finds one)."""
    root = make_root(str(tmp_path))
    code = (
        "import sys, time; t0 = time.perf_counter(); sys.path[:0] = [%r, %r]; from bmk.cli import main; "
        "rc = main(['--workload', 'm.sections', '--seed', '3000000011', '--seconds', '0.2', '--trace', '0', "
        "'--device', 'cpu'], t0, %r); "
        "print(sorted({m.split('.')[0] for m in sys.modules})); sys.exit(rc)" % (BENCH, REPO, root)
    )
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    got = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=600)
    assert got.returncode == 0, got.stderr[-3000:]
    tops = set(eval(got.stdout.strip().splitlines()[-1]))
    assert "bootstrapper_torch" in tops and not tops & JAX_SIDE


def test_a_run_refuses_without_a_card():
    """Asked for the card where there is none, the run exits with another
    code than 0 and prints no result."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    got = subprocess.run(
        [sys.executable, os.path.join(BENCH, "run.py"), "--workload", "3d_affs.predict_stream", "--seed", "1",
         "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=REPO, timeout=300,
    )
    assert got.returncode != 0 and not got.stdout.strip()


def test_a_run_refuses_without_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    folder, a run (here on the CPU, past the look for a card) fails and
    prints no result."""
    import shutil

    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    got = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "3d_affs.predict_stream", "--seed", "1", "--seconds", "1",
         "--trace", "0", "--device", "cpu"],
        capture_output=True, text=True, cwd=tmp_path, env=env, timeout=300,
    )
    assert got.returncode != 0 and not got.stdout.strip()
    assert "bootstrapper_torch" in got.stderr
