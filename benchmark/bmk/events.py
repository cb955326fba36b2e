"""Reductions of a recorded trace, shared by the per-layer metric readers.

A trace is a list of events, each a dict: ``name``, ``dev`` (``"cpu"`` or
``"cuda"``), ``ts`` and ``dur`` (microseconds on one clock), ``corr`` (the
event's correlation id), ``link`` (a device event's: the ``corr`` of the
host op that launched it; 0 where unknown), ``user`` (a span the harness
opened with ``record_function``).  ``bmk/trace.py`` makes it from
``torch.profiler``; tests write it by hand.
"""

from __future__ import annotations

import bisect

#: device events that are copies or fills, not kernels
COPY_WORDS = ("memcpy", "memset")
#: the program's conv kernel K1 (``csrc/conv3d.cu``), not the int8 one
K1_WORDS = ("conv3d_kernel_bf16", "conv3d_kernel_f32")
#: a frozen copy of ``chip_smoke.py:device_groups``'s library-conv words
LIBRARY_CONV_WORDS = ("conv", "xmma", "cudnn", "implicit", "gemm", "cutlass")


def device_events(events) -> list:
    return [e for e in events if e["dev"] == "cuda" and not e.get("user")]


def is_copy(e) -> bool:
    low = e["name"].lower()
    return any(w in low for w in COPY_WORDS)


def is_k1(e) -> bool:
    low = e["name"].lower()
    return any(w in low for w in K1_WORDS) and "qconv" not in low


def is_conv(e) -> bool:
    """A convolution on the card: K1, the int8 kernel K4 with its
    quantization passes, or the library's (cuDNN, cuBLAS-backed)."""
    low = e["name"].lower()
    return (
        "conv3d_kernel" in low
        or "s8_amax" in low
        or "s8_quantize" in low
        or any(w in low for w in LIBRARY_CONV_WORDS)
    )


#: words of the matrix products' kernel names: cuBLAS's and cuBLASLt's
#: (``sm90_xmma_gemm_*``, ``ampere_sgemm_*``, ``cutlass_*``, ``gemv*``,
#: their split-K reductions) and the CUTLASS kernels they launch
GEMM_WORDS = ("gemm", "gemv", "xmma", "cutlass", "splitkreduce")


def is_gemm(e) -> bool:
    """A matrix product on the card (a library one: the port writes none)."""
    low = e["name"].lower()
    return any(w in low for w in GEMM_WORDS)


def spans(events, name) -> list:
    """``[(start, end)]`` of the host's user ranges called ``name`` (the
    harness's and the program's spans): a device-side range of the same
    name, which a CUDA trace can hold, is none."""
    return [(e["ts"], e["ts"] + e["dur"]) for e in events
            if e["dev"] == "cpu" and e.get("user") and e["name"] == name]


def window(events):
    """The traced window: the span ``bmk.window``."""
    got = spans(events, "bmk.window")
    if len(got) != 1:
        raise ValueError(f"a trace holds one bmk.window span, not {len(got)}")
    return got[0]


def merged(intervals) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def clipped(intervals, lo, hi) -> list:
    return [(max(a, lo), min(b, hi)) for a, b in intervals if min(b, hi) > max(a, lo)]


def busy_us(events, lo, hi) -> float:
    """Time in ``[lo, hi]`` in which some kernel or copy ran on the card."""
    iv = merged(clipped([(e["ts"], e["ts"] + e["dur"]) for e in device_events(events)], lo, hi))
    return sum(b - a for a, b in iv)


def kernel_us(events, pred=lambda e: True) -> float:
    """Summed durations of the device's kernels (not copies) that ``pred``
    admits."""
    return sum(e["dur"] for e in device_events(events) if not is_copy(e) and pred(e))


def host_op_corrs(events, intervals) -> set:
    """The ``corr`` of each host op that began inside one of ``intervals``
    (``[(start, end)]``).  A device event's ``link`` is the ``corr`` of the
    host op (an ``aten::`` op) that launched it; the CUDA runtime calls in
    between carry that id as their own ``link`` and a ``corr`` from another
    count, which overlaps the ops' ids, so host events with a ``link`` of
    their own are left out."""
    inside = merged(intervals)
    starts = [a for a, _ in inside]

    def within(ts) -> bool:
        i = bisect.bisect_right(starts, ts) - 1
        return i >= 0 and ts < inside[i][1]

    return {e["corr"] for e in events
            if e["dev"] == "cpu" and not e.get("user") and not e.get("link") and e.get("corr") and within(e["ts"])}


def launched_in(events, span_name) -> float:
    """Summed durations of the device events (kernels, copies, fills)
    launched by host ops that began inside one of the host spans called
    ``span_name`` (``host_op_corrs``)."""
    corrs = host_op_corrs(events, spans(events, span_name))
    return sum(e["dur"] for e in device_events(events) if e.get("link") in corrs)


def idle_gaps(events, lo, hi, top: int = 10) -> list:
    """The ``top`` longest stretches of ``[lo, hi]`` with nothing on the
    card, each named by what the host was doing at its middle: the
    innermost of the harness's spans and the host ops there."""
    iv = merged(clipped([(e["ts"], e["ts"] + e["dur"]) for e in device_events(events)], lo, hi))
    gaps, t = [], lo
    for a, b in iv:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if hi > t:
        gaps.append((t, hi))
    gaps.sort(key=lambda g: g[0] - g[1])
    host = [e for e in events if e["dev"] == "cpu"]
    out = []
    for a, b in gaps[:top]:
        mid = (a + b) / 2
        inside = [e for e in host if e["ts"] <= mid < e["ts"] + e["dur"]]
        users = [e for e in inside if e.get("user") and e["name"] != "bmk.window"]
        ops = [e for e in inside if not e.get("user")]
        parts = [min(users, key=lambda e: e["dur"])["name"]] if users else []
        if ops:
            parts.append(min(ops, key=lambda e: e["dur"])["name"])
        out.append([" / ".join(parts) or "host outside any traced op", (b - a) / 1e6])
    return out


def top_device_ops(events, top: int = 10) -> list:
    """``[[name, seconds]]`` of the device operations that took most time,
    summed by name."""
    by = {}
    for e in device_events(events):
        by[e["name"]] = by.get(e["name"], 0.0) + e["dur"]
    return [[n[:100], us / 1e6] for n, us in sorted(by.items(), key=lambda kv: -kv[1])[:top]]
