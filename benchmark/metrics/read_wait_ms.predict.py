"""Host milliseconds a step the dispatch loop of the predict pipeline
waited for its reader thread (the program's span ``bs.predict.read_wait``),
over the traced pass's steps (``bs.predict.dispatch``)."""

from bmk.spans import host_ms_per


def read(record: dict):
    return host_ms_per(record, "predict", "bs.predict.read_wait", "bs.predict.dispatch")
