"""Mean host time a window step waited for its batch (ms): the benchmark's
span around the call into the loader and the copy to the card."""


def read(record):
    waits = record["window"].get("loader_wait_s")
    if record["kind"] != "train" or not waits:
        return None
    return 1e3 * sum(waits) / len(waits)
