"""Device ms a profiled step spent in the port's BatchNorm kernels (by kernel
name: every ``css_bn_`` kernel of ``css_tpu_torch/csrc/batchnorm_kernels.cu``);
None where the program has none."""

NAME_PART = "css_bn_"


def read(record):
    t = record["trace"]
    if record["kind"] != "train" or not t or not t.get("kernels"):
        return None
    ms = [v for name, v in t["ms_by_name"].items() if NAME_PART in name]
    return sum(ms) if ms else None
