"""Device operations a step (kernels, copies, fills) launched by host ops
that began inside the program's span ``bs.train.step`` (the backward's
on the autograd engine's thread too), over the traced steps."""

from bmk.spans import launches_per


def read(record: dict):
    return launches_per(record, "train", "bs.train.step", "bs.train.step")
