"""Device operations a step (kernels, copies, fills) launched by host ops
that began inside the program's span ``bs.train.transform``, over the
traced steps (``bs.train.step``)."""

from bmk.spans import launches_per


def read(record: dict):
    return launches_per(record, "train", "bs.train.transform", "bs.train.step")
