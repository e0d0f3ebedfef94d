"""1 - (device busy a step) / (a step's time): the busy union of the kernel
intervals of the profiled steps, per step, over the mean of the untraced
window's step times (CUDA events), since the profiler's own host cost
stretches the steps it records."""


def read(record):
    t = record["trace"]
    step_ms = record["window"].get("step_ms")
    if record["kind"] != "train" or not t or not t.get("kernels") or not step_ms:
        return None
    busy_ms = 1e3 * t["busy_s"] / t["units"]
    return 1.0 - busy_ms / (sum(step_ms) / len(step_ms))
