"""Device ms a profiled step spent in elementwise and reduction kernels
(BatchNorm, activations, losses; by kernel name)."""


def read(record):
    t = record["trace"]
    if record["kind"] != "train" or not t or not t.get("kernels"):
        return None
    cats = t["ms_by_category"]
    return cats.get("elementwise", 0.0) + cats.get("reduction", 0.0)
