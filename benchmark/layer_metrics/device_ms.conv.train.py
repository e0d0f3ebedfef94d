"""Device ms a profiled step spent in convolution and matrix-product
kernels (by kernel name, ``benchmark/devtrace.py``'s categories)."""


def read(record):
    t = record["trace"]
    if record["kind"] != "train" or not t or not t.get("kernels"):
        return None
    cats = t["ms_by_category"]
    return cats.get("conv", 0.0) + cats.get("matmul", 0.0)
