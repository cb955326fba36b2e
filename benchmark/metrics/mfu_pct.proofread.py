"""A section's least work (``flops.sam_section_flops``: the encoder once,
the decoder at each click) times the window's sections, over the window's
wall time at the card's bf16 peak (the program computes in fp32: the
bf16 peak keeps any precision a later change may take under 100)."""

from bmk.layer import mfu_pct


def read(record: dict):
    if record.get("kind") != "proofread":
        return None
    return mfu_pct(record["sections"] * record["flops_per_section"], record["window_s"])
