"""Host milliseconds a step in the device transform (the program's span
``bs.train.transform``: the upload, the augments, the targets), over the
traced steps (``bs.train.step``)."""

from bmk.spans import host_ms_per


def read(record: dict):
    return host_ms_per(record, "train", "bs.train.transform", "bs.train.step")
