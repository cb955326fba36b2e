"""``torch.profiler`` around a stretch of the window, reduced to the event
list of ``bmk/events.py``."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def span(name: str):
    """One of the harness's own spans (a user annotation in the trace)."""
    with torch.profiler.record_function(name):
        yield


class Tracer:
    """``with tracer:`` profiles the host and, on CUDA, the device, inside a
    ``bmk.window`` span; ``events`` then holds the reduced trace."""

    def __init__(self, device):
        acts = [torch.profiler.ProfilerActivity.CPU]
        self.cuda = torch.device(device).type == "cuda"
        if self.cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.events = None
        self._span = None

    def __enter__(self):
        if self.cuda:
            torch.cuda.synchronize()
        self.prof.__enter__()
        self._span = span("bmk.window")
        self._span.__enter__()
        return self

    def __exit__(self, *exc):
        if self.cuda:
            torch.cuda.synchronize()
        self._span.__exit__(*exc)
        self.prof.__exit__(*exc)
        if exc[0] is None:
            self.events = reduce(self.prof)
        return False


def reduce(prof) -> list:
    out = []
    for e in prof.profiler.kineto_results.events():
        dev = e.device_type()
        if dev == torch.autograd.DeviceType.CUDA:
            kind = "cuda"
        elif dev == torch.autograd.DeviceType.CPU:
            kind = "cpu"
        else:
            continue
        out.append(
            {
                "name": e.name(),
                "dev": kind,
                "ts": e.start_ns() / 1e3,
                "dur": e.duration_ns() / 1e3,
                "corr": int(e.correlation_id()),
                "link": int(e.linked_correlation_id()),
                "user": bool(e.is_user_annotation()),
            }
        )
    return out
