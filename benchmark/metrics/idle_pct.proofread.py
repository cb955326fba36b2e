"""The card's idle share of the traced sections (``bmk.layer``)."""

from bmk.layer import idle_pct


def read(record: dict):
    return idle_pct(record, "proofread")
