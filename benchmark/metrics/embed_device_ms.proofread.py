"""Device milliseconds a section of what its embedding launched (host ops
that began inside the harness's span ``bmk.embed``, around
``SamPredictor.set_image``: the section's upload and resize, the image
encoder), over the traced embeddings."""

from bmk import events as E


def read(record: dict):
    trace = record.get("trace")
    if record.get("kind") != "proofread" or not trace or not E.device_events(trace):
        return None
    embeds = len(E.spans(trace, "bmk.embed"))
    if not embeds:
        return None
    return E.launched_in(trace, "bmk.embed") / 1e3 / embeds
