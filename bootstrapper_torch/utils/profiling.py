"""Tracing: the program's spans and the operator's trace.

- ``span(name)``: a named range at a layer boundary of the program.  While
  a ``torch.profiler`` records, it is a ``record_function`` range, so it
  lands in that trace on the clock of the device's kernels; otherwise it
  is one shared null context, and costs an attribute read and a call.
  Any profiler picks the spans up: ``torch_trace`` below, or a caller's
  own.  A profiler sees a span only on the threads it records, by
  default the one that started it.
- ``torch_trace``: a ``torch.profiler`` trace (host and CUDA activities,
  every thread where the installed torch can record them, written as
  Chrome trace JSON) around a region when ``BS_PROFILE=<dir>`` is set;
  with it unset the region runs untraced.  ``run_prediction`` traces each
  link's pass, ``_train`` a stretch of iterations.
"""

from __future__ import annotations

import contextlib
import logging
import os

import torch
from torch.autograd import profiler as _autograd_profiler

logger = logging.getLogger(__name__)

_UNTRACED = contextlib.nullcontext()


def span(name: str):
    """A ``with`` block named ``name`` in a profiler's trace, while one
    records (``torch.profiler.record_function``); a shared null context
    when none does."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _UNTRACED


def _all_threads() -> dict:
    """The profiler's argument that records every thread's ranges (the
    predict reader's, the loader's workers'), where this torch has it."""
    try:
        from torch._C._profiler import _ExperimentalConfig

        return {"experimental_config": _ExperimentalConfig(profile_all_threads=True)}
    except (ImportError, TypeError):
        return {}


@contextlib.contextmanager
def torch_trace(name: str = "trace"):
    """Profile the wrapped region when BS_PROFILE is set to a directory:
    ``<BS_PROFILE>/<name>/trace.json``, CUDA activity included where a
    device is there."""
    profile_dir = os.environ.get("BS_PROFILE")
    if not profile_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    path = os.path.join(profile_dir, name)
    os.makedirs(path, exist_ok=True)
    with torch.profiler.profile(activities=activities, **_all_threads()) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()  # the region's queued device work lands in the trace
    prof.export_chrome_trace(os.path.join(path, "trace.json"))
    logger.info("torch trace written to %s", path)
