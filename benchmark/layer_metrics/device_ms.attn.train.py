"""Device ms a profiled step spent in attention kernels, forward and
backward (by kernel name: the lower-cased name holds one of ``NAME_PARTS``,
as PyTorch's fused attention kernels are named, flash and memory-efficient
alike); None where the program runs none."""

NAME_PARTS = ("flash", "fmha", "attention", "sdpa")


def read(record):
    t = record["trace"]
    if record["kind"] != "train" or not t or not t.get("kernels"):
        return None
    ms = [v for name, v in t["ms_by_name"].items()
          if any(part in name.lower() for part in NAME_PARTS)]
    return sum(ms) if ms else None
