"""K1's share of its roofline over the traced pass (``bmk.layer``)."""

from bmk.layer import k1_roofline_pct


def read(record: dict):
    return k1_roofline_pct(record, "predict")
