"""Host milliseconds a step of the predict pipeline's ROI-clipped output
writes (the program's span ``bs.predict.write``), over the traced pass's
steps (``bs.predict.dispatch``)."""

from bmk.spans import host_ms_per


def read(record: dict):
    return host_ms_per(record, "predict", "bs.predict.write", "bs.predict.dispatch")
