"""A step's fixed work (``flops.train_step_flops``: the forward's and
backward's conv products) times the window's steps, over the window's
wall time at the card's bf16 peak."""

from bmk.layer import mfu_pct


def read(record: dict):
    if record.get("kind") != "train":
        return None
    return mfu_pct(record["steps"] * record["flops_per_step"], record["window_s"])
