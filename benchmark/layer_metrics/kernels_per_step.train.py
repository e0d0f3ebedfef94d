"""CUDA kernels a profiled step launched (kernel records over the steps;
copies and fills are not launches)."""


def read(record):
    t = record["trace"]
    if record["kind"] != "train" or not t or not t.get("kernels"):
        return None
    return t["launches"] / t["units"]
