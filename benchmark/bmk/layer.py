"""Arithmetic the per-layer metric readers share (``metrics/*.py``): each
takes a run's record and gives its number, or None where the record holds
nothing to read."""

from __future__ import annotations

from . import events as E
from . import flops as F


def idle_pct(record: dict, kind: str):
    """Share of the traced window with no kernel or copy on the card."""
    trace = record.get("trace")
    if record.get("kind") != kind or not trace or not E.device_events(trace):
        return None
    lo, hi = E.window(trace)
    return 100.0 * (1.0 - E.busy_us(trace, lo, hi) / (hi - lo))


def k1_roofline_pct(record: dict, kind: str):
    """The conv kernel K1's least time at every shape it was launched at,
    times its launches there (the program's counter), over its device time
    in the trace (by kernel name)."""
    trace, launches = record.get("trace"), record.get("k1_launches")
    if record.get("kind") != kind or not trace or not launches:
        return None
    k1_us = E.kernel_us(trace, E.is_k1)
    if not k1_us:
        return None
    least_s = sum(F.bound_s(*F.conv_key_work(x, w)) * n for (x, w), n in launches.items())
    return 100.0 * least_s * 1e6 / k1_us


def mfu_pct(work_flops: float, window_s: float):
    """Work over the window at the card's bf16 peak."""
    if not window_s:
        return None
    return 100.0 * work_flops / (window_s * F.PEAK_BF16)
