"""The least work of the window's passes (``flops.least_volume_flops``:
one valid forward whose output is the whole volume) over the window's
wall time at the card's bf16 peak."""

from bmk.layer import mfu_pct


def read(record: dict):
    if record.get("kind") != "predict":
        return None
    return mfu_pct(record["passes"] * record["least_flops_per_pass"], record["window_s"])
