"""Milliseconds a click on a section already embedded takes in
``ProofreadSession.segment_from_point`` (the harness's spans ``bmk.click``
that hold no ``bmk.embed``): the decoding's dispatch and device work, the
masks' two resizes and copy to the host, the choice of a mask and the label
write, over the traced such clicks."""

from bmk import events as E


def read(record: dict):
    trace = record.get("trace")
    if record.get("kind") != "proofread" or not trace:
        return None
    embeds = E.spans(trace, "bmk.embed")
    clicks = [(a, b) for a, b in E.spans(trace, "bmk.click") if not any(a <= c < b for c, _ in embeds)]
    if not clicks:
        return None
    return sum(b - a for a, b in clicks) / 1e3 / len(clicks)
