"""Host milliseconds a step of the predict pipeline's dispatch: the
staging copy and queueing a step's device work (the program's span
``bs.predict.dispatch``), over the traced pass's steps."""

from bmk.spans import host_ms_per


def read(record: dict):
    return host_ms_per(record, "predict", "bs.predict.dispatch", "bs.predict.dispatch")
