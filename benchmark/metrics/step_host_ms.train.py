"""Host milliseconds a step in the train step (the program's span
``bs.train.step``: forward, backward, Adam), over the traced steps."""

from bmk.spans import host_ms_per


def read(record: dict):
    return host_ms_per(record, "train", "bs.train.step", "bs.train.step")
