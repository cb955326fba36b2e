"""Device milliseconds a traced step spends in what the device transform
(the harness's span around ``TrainingPipeline.transform_batch``)
launched: uploads, augments, targets, weights."""

from bmk import events as E


def read(record: dict):
    trace = record.get("trace")
    if record.get("kind") != "train" or not trace or not record.get("trace_steps"):
        return None
    us = E.launched_in(trace, "bmk.transform")
    if not us:
        return None
    return us / 1e3 / record["trace_steps"]
