"""``bs-torch doctor``: the environment the port's kernels will be built
and run in, as one JSON line.

Reports ``torch.version.cuda``, the device's name and compute capability
(the kernels target (9, 0)), whether ``triton`` and the optional Python
packages import (``networkx``: skeleton metrics and threshold sweeps;
``click``: this command line; ``imageio``: ``utils convert`` and
``prepare volumes`` from TIFF or image stacks; ``zstandard``: reading the
zstd-compressed Zarr arrays the JAX package writes), and the paths of
``nvcc``, ``ninja`` and ``g++``.  Exits 1 when there is no CUDA device or
no ``nvcc``, since the kernels can then neither build nor run.  The JAX
package's doctor probes a TPU relay and the XLA cache; neither exists
here.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import shutil
import sys

import click


def _imports(name: str) -> bool:
    try:
        importlib.import_module(name)
    except ImportError:
        return False
    return True


def doctor() -> dict:
    import torch

    from ..ops._build import nvcc_path

    info = {
        "python": sys.version.split()[0],
        "torch": torch.__version__,
        "torch_cuda": torch.version.cuda,
        "cuda_available": torch.cuda.is_available(),
        "device_count": torch.cuda.device_count() if torch.cuda.is_available() else 0,
        "triton": importlib.util.find_spec("triton") is not None,
        **{name: _imports(name) for name in ("networkx", "click", "imageio", "zstandard")},
        "nvcc": nvcc_path(),
        "ninja": shutil.which("ninja"),
        "gxx": shutil.which("g++"),
    }
    if info["cuda_available"]:
        info["device"] = torch.cuda.get_device_name(0)
        info["capability"] = list(torch.cuda.get_device_capability(0))
    return info


@click.command("doctor")
def doctor_command():
    """Report the environment as one JSON line; exit 1 without a CUDA
    device or nvcc."""
    info = doctor()
    click.echo(json.dumps(info))
    if not (info["cuda_available"] and info["nvcc"]):
        click.get_current_context().exit(1)
