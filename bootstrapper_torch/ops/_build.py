"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled by its own ``nvcc`` into
``_build/lib<name>.so``, a shared library with a plain C interface (no
PyTorch headers, so a build takes seconds).  ``build_all`` starts one
``nvcc`` per stale source, all at once, and waits for every one.  A
library is stale when its source, or any file under ``csrc/`` that the
source includes (``#include "..."``, followed recursively), is newer.
The target is ``sm_90a`` (Hopper; ``wgmma`` needs the ``a``).  Nothing
here runs when the package is imported; a build failure raises with the
compiler's output, and ``LOGS`` keeps the output of the builds that
succeeded (ptxas' register and spill report, warnings).
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "_build")
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
SOURCES = ("conv3d", "seed_maxima")

#: compiler output of each build made by this process, by source name
LOGS: dict = {}

_LOCK = threading.Lock()
_LIBS: dict = {}
_INCLUDE_RE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def nvcc_path() -> str | None:
    """``$CUDA_HOME/bin/nvcc``, else ``/usr/local/cuda/bin/nvcc``, else PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    return shutil.which("nvcc")


def lib_path(name: str) -> str:
    return os.path.join(BUILD, f"lib{name}.so")


def source_files(name: str, csrc: str | None = None) -> list:
    """``<name>.cu`` and every file under ``csrc`` it includes with
    ``#include "..."``, directly or through another such file."""
    csrc = CSRC if csrc is None else csrc
    todo, seen = [os.path.join(csrc, f"{name}.cu")], []
    while todo:
        path = todo.pop()
        if path in seen or not os.path.exists(path):
            continue
        seen.append(path)
        with open(path) as f:
            for inc in _INCLUDE_RE.findall(f.read()):
                todo.append(os.path.normpath(os.path.join(os.path.dirname(path), inc)))
    return seen


def _stale(name: str) -> bool:
    out = lib_path(name)
    if not os.path.exists(out):
        return True
    built = os.path.getmtime(out)
    return any(built < os.path.getmtime(src) for src in source_files(name))


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
            nvcc, ARCH, "-std=c++17", "-O3", "-lineinfo", "-Xptxas", "-v", "-shared",
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
            LOGS[name] = logs[name]
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
