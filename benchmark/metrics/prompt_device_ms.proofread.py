"""Device milliseconds a click of what the click's ``SamPredictor.predict``
launched (host ops that began inside the harness's span ``bmk.prompt``:
the prompt encoder, the mask decoder, the masks' two resizes and their
copy to the host), over the traced clicks."""

from bmk import events as E


def read(record: dict):
    trace = record.get("trace")
    if record.get("kind") != "proofread" or not trace or not E.device_events(trace):
        return None
    clicks = len(E.spans(trace, "bmk.prompt"))
    if not clicks:
        return None
    return E.launched_in(trace, "bmk.prompt") / 1e3 / clicks
