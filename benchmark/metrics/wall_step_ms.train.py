"""The window's wall time over its steps: the host loader, the device
transform, forward, backward and Adam (host clock; a ``--trace 1`` run's
window runs untraced)."""


def read(record: dict):
    if record.get("kind") != "train" or not record.get("steps"):
        return None
    return record["window_s"] / record["steps"] * 1e3
