"""``python -m bootstrapper_torch doctor``: the environment the port's
kernels will be built and run in, as one JSON line.

Reports ``torch.version.cuda``, the device's name and compute capability
(the kernels target (9, 0)), whether ``triton`` and ``networkx`` import
(skeleton metrics and threshold sweeps need networkx; VOI, prediction
errors and the filter do not), and the paths of ``nvcc``, ``ninja`` and
``g++``.  Exits 1 when there is no CUDA device or
no ``nvcc``, since the kernels can then neither build nor run.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import shutil
import sys

import torch

from .ops._build import nvcc_path


def _imports(name: str) -> bool:
    try:
        importlib.import_module(name)
    except ImportError:
        return False
    return True


def doctor() -> dict:
    info = {
        "python": sys.version.split()[0],
        "torch": torch.__version__,
        "torch_cuda": torch.version.cuda,
        "cuda_available": torch.cuda.is_available(),
        "device_count": torch.cuda.device_count() if torch.cuda.is_available() else 0,
        "triton": importlib.util.find_spec("triton") is not None,
        "networkx": _imports("networkx"),
        "nvcc": nvcc_path(),
        "ninja": shutil.which("ninja"),
        "gxx": shutil.which("g++"),
    }
    if info["cuda_available"]:
        info["device"] = torch.cuda.get_device_name(0)
        info["capability"] = list(torch.cuda.get_device_capability(0))
    return info


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m bootstrapper_torch")
    parser.add_argument("command", choices=["doctor"])
    parser.parse_args(argv)
    info = doctor()
    print(json.dumps(info))
    return 0 if info["cuda_available"] and info["nvcc"] else 1


if __name__ == "__main__":
    sys.exit(main())
