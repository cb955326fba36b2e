"""Profiling & tracing helpers (the JAX package's ``utils/profiling.py``).

- ``stage_timer``: wall-clock + JSONL logging for pipeline stages;
- ``torch_trace``: a ``torch.profiler`` trace (host and CUDA activities,
  written as Chrome trace JSON) around any region when
  ``BS_PROFILE=<dir>`` is set; with it unset the region runs untraced.

As in the JAX package, no path of the port calls either: they are tools
to wrap around a region by hand.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import time

logger = logging.getLogger(__name__)


@contextlib.contextmanager
def stage_timer(name: str, log_path: str | None = None):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        logger.info("%s: %.2fs", name, dt)
        if log_path:
            with open(log_path, "a") as f:
                f.write(json.dumps({"stage": name, "seconds": dt}) + "\n")


@contextlib.contextmanager
def torch_trace(name: str = "trace"):
    """Profile the wrapped region when BS_PROFILE is set to a directory:
    ``<BS_PROFILE>/<name>/trace.json``, CUDA activity included where a
    device is there."""
    profile_dir = os.environ.get("BS_PROFILE")
    if not profile_dir:
        yield
        return
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    path = os.path.join(profile_dir, name)
    os.makedirs(path, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(path, "trace.json"))
    logger.info("torch trace written to %s", path)
