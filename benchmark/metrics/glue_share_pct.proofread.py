"""The share of the card's kernel time, in the traced sections, spent in
kernels that are no matrix product or convolution: softmax, the relative
positions' adds, LayerNorm, GELU, the resizes' transposes and the
elementwise work (copies left out of both)."""

from bmk import events as E


def read(record: dict):
    trace = record.get("trace")
    if record.get("kind") != "proofread" or not trace:
        return None
    total = E.kernel_us(trace)
    if not total:
        return None
    return 100.0 * E.kernel_us(trace, lambda e: not E.is_conv(e) and not E.is_gemm(e)) / total
