"""Model FLOPs of the window's steps over its wall time, as a share of the
card's dense bf16 peak (%): the student's forward and backward (x3) on both
batches and the teacher's forward, counted from shapes."""


def read(record):
    w = record["window"]
    if record["kind"] != "train" or not w["steps"]:
        return None
    return 100.0 * record["flops_per_step"] * w["steps"] / w["seconds"] \
        / record["peak_flop_per_s"]
