"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled by its own ``nvcc`` into
``_build/lib<name>.so``, a shared library with a plain C interface (no
PyTorch headers, so a build takes seconds).  ``build_all`` starts one
``nvcc`` per stale source, all at once, and waits for every one.  The
target is ``sm_90a`` (Hopper).  Nothing here runs when the package is
imported; a build failure raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "_build")
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
SOURCES = ("conv3d", "seed_maxima")

_LOCK = threading.Lock()
_LIBS: dict = {}


def nvcc_path() -> str | None:
    """``$CUDA_HOME/bin/nvcc``, else ``/usr/local/cuda/bin/nvcc``, else PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    return shutil.which("nvcc")


def lib_path(name: str) -> str:
    return os.path.join(BUILD, f"lib{name}.so")


def _stale(name: str) -> bool:
    out = lib_path(name)
    if not os.path.exists(out):
        return True
    src = os.path.join(CSRC, f"{name}.cu")
    return os.path.getmtime(out) < os.path.getmtime(src)


def build_all(names=SOURCES) -> None:
    """Compile every stale source in ``names``, one nvcc each, in parallel;
    raise with the compiler's output if any fails."""
    todo = [n for n in names if _stale(n)]
    if not todo:
        return
    nvcc = nvcc_path()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME); the port's CUDA kernels are "
            "built from bootstrapper_torch/csrc at first use"
        )
    os.makedirs(BUILD, exist_ok=True)
    procs = {}
    for name in todo:
        tmp = f"{lib_path(name)}.{os.getpid()}.tmp"
        cmd = [
            nvcc, ARCH, "-std=c++17", "-O3", "-lineinfo", "-shared",
            "-Xcompiler", "-fPIC", "-o", tmp, os.path.join(CSRC, f"{name}.cu"),
        ]
        procs[name] = (
            tmp,
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            ),
        )
    logs, failed = {}, []
    for name, (tmp, proc) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, lib_path(name))
        else:
            failed.append(name)
            if os.path.exists(tmp):
                os.unlink(tmp)
    if failed:
        raise RuntimeError(
            "nvcc failed for "
            + ", ".join(failed)
            + ":\n"
            + "\n".join(logs[n] for n in failed)
        )


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu`` (built first if stale),
    with ``signatures`` (``{function: (argtypes, restype)}``) declared."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build_all((name,))
            lib = ctypes.CDLL(lib_path(name))
            for fn, (argtypes, restype) in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _LIBS[name] = lib
        return lib
