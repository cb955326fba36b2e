"""K1's share of its roofline over the traced steps (``bmk.layer``): the
training forward's launches (the backward runs in the library)."""

from bmk.layer import k1_roofline_pct


def read(record: dict):
    return k1_roofline_pct(record, "train")
