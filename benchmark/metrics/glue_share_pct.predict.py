"""The share of the card's kernel time, in the traced pass, spent in
kernels that are no convolution (not K1, K4 or the library's): the
upsample, copies, pooling, adds and the stream's caches."""

from bmk import events as E


def read(record: dict):
    trace = record.get("trace")
    if record.get("kind") != "predict" or not trace:
        return None
    total = E.kernel_us(trace)
    if not total:
        return None
    return 100.0 * E.kernel_us(trace, lambda e: not E.is_conv(e)) / total
