"""Host milliseconds a step spends in the harness's span around taking
the next host batch from the loader's queue, over the window."""


def read(record: dict):
    if record.get("kind") != "train" or not record.get("steps"):
        return None
    return 1e3 * record["loader_wait_s"] / record["steps"]
