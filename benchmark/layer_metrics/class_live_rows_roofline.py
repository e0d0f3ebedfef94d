"""``class_live_rows_kernel``'s share of its roofline (%): the least time
for its inputs read once at the card's memory bandwidth
(``benchmark/flops.py``), over its mean device time a launch."""


def read(record):
    t = record["trace"]
    if record["kind"] != "train" or not t or not t.get("kernels"):
        return None
    names = [n for n in t["count_by_name"] if "class_live_rows" in n]
    launches = sum(t["count_by_name"][n] for n in names)
    if not launches:
        return None
    device_ms = sum(t["ms_by_name"][n] for n in names) * t["units"] / launches
    bound_ms = record["class_live_rows_bytes"] / record["hbm_bytes_per_s"] * 1e3
    return 100.0 * bound_ms / device_ms
