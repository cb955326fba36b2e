"""The program's spans (``bootstrapper_torch/utils/profiling.py:span``) in
a recorded trace (``bmk/events.py``'s events), for the per-layer metric
readers: host ranges by name, their time, and the device work launched
from inside them, each per step of the traced stretch.

A span is a host-side user range (``dev == "cpu"``); a device-side range
of the same name, which a CUDA trace can hold, is neither a span nor
work.  Each function gives None where the record is of another kind,
holds no trace, or has no span to divide by: the program of an older
commit opens none, and its run then reports no such metric.
"""

from __future__ import annotations

from . import events as E


def _steps(record: dict, kind: str, per: str):
    """``(trace, number of spans called per)``, or None."""
    trace = record.get("trace")
    if record.get("kind") != kind or not trace:
        return None
    n = len(E.spans(trace, per))
    return (trace, n) if n else None


def host_ms_per(record: dict, kind: str, name: str, per: str):
    """Summed host milliseconds of the spans called ``name`` over the
    number of spans called ``per``."""
    got = _steps(record, kind, per)
    if got is None:
        return None
    trace, n = got
    return sum(b - a for a, b in E.spans(trace, name)) / 1e3 / n


def launches_per(record: dict, kind: str, name: str, per: str):
    """Device operations (kernels, copies, fills) whose host op began
    inside a span called ``name``, each once, wherever it ran on the card
    in time, over the number of spans called ``per``; None in a trace with
    no device operation.  Host ops are matched by ``E.host_op_corrs``,
    never the runtime calls, whose ids would count a device operation
    launched elsewhere."""
    got = _steps(record, kind, per)
    if got is None or not E.device_events(got[0]):
        return None
    trace, n = got
    corrs = E.host_op_corrs(trace, E.spans(trace, name))
    return sum(1 for e in E.device_events(trace) if e.get("link") in corrs) / n
