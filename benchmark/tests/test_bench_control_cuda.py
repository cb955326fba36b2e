"""The correctness check's controls at each cell's own size, on the card:
each has to come out not correct.  Run on a machine with an NVIDIA GPU:

    python -m pytest benchmark/tests/test_bench_control_cuda.py -m cuda
"""

import json
import subprocess
import sys

import pytest

from tiny import REPO

CONTROLS = [
    ("3d_affs.predict_stream", "program_int8"),
    ("3d_affs.predict_stream", "reference_int8"),
    ("3d_affs.train", "reference_int8"),
    ("sam_vit_h.proofread_sections", "reference_bf16"),
    ("sam_vit_h.proofread_sections", "reference_tf32"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("cell,control", CONTROLS)
def test_control_is_not_correct(cell, control):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    got = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed", "3000000021", "--seconds", "1",
         "--trace", "0", "--control", control],
        capture_output=True, text=True, cwd=REPO, timeout=1200,
    )
    assert got.returncode == 0, got.stderr[-3000:]
    assert json.loads(got.stdout.strip().splitlines()[-1])["correct"] is False
