"""Device trace of a few steps: kernels by name and category, the device's
busy union, and the longest idle gaps with what the host was doing.

``profile_units(run_one, units)`` runs one unit (a step or an eval batch)
under ``torch.profiler`` to warm it up and discards it (the profiler loses
the first records of a window on the card), then ``units`` more that it
keeps, with the device drained before and after them and never in between.
The categories are matched on the lower-cased kernel name, first match
first; a layout transpose (``nchwToNhwc`` and the like) is no convolution.
``kernels`` counts every device record (kernels, copies, fills),
``launches`` the kernels alone.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

__all__ = ["CATEGORIES", "COPIES", "category", "is_launch", "profile_units", "summarise"]

CATEGORIES = (
    ("contrastive", ("class_live_rows", "k1_live", "k2_live", "sum_partials", "count_live",
                     "scatter_live")),
    ("nccl", ("nccl",)),
    ("conv", ("conv", "wgrad", "dgrad", "xmma", "cudnn")),
    ("matmul", ("gemm", "cutlass", "sm90")),
    ("elementwise", ("elementwise", "vectorized")),
    ("reduction", ("reduce",)),
)


COPIES = ("Memcpy", "Memset")      # the profiler's names of copies and fills


def is_launch(name: str) -> bool:
    """A kernel launch, not a copy or a fill."""
    return not name.startswith(COPIES)


def category(name: str) -> str:
    low = name.lower()
    return next((c for c, keys in CATEGORIES if any(k in low for k in keys)), "other")


def profile_units(run_one: Callable[[], None], units: int, device: torch.device) -> dict:
    """Kernel records [(name, start_us, end_us)] of ``units`` units and the
    host's op records [(name, start_us, end_us)] over the same span (off the
    card: host records only)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    cuda = device.type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sched = schedule(wait=0, warmup=1, active=1, repeat=1)

    def drain():
        if cuda:
            torch.cuda.synchronize(device)

    with profile(activities=activities, schedule=sched) as prof:
        run_one()
        drain()
        prof.step()
        t0 = time.perf_counter()
        for _ in range(units):
            run_one()
        drain()
        host_s = time.perf_counter() - t0
        prof.step()
    t1 = time.perf_counter()
    kernels, host = [], []
    for e in prof.events():
        rec = (e.name, e.time_range.start, e.time_range.end)
        if e.device_type != DeviceType.CUDA:
            host.append(rec)
        elif not (getattr(e, "is_user_annotation", False) or e.name.startswith("ProfilerStep")):
            kernels.append(rec)      # kernels, copies and fills; not the step's own range
    kernels.sort(key=lambda r: r[1])
    return {"kernels": kernels, "host": host, "units": units, "host_s": host_s,
            "read_s": time.perf_counter() - t1}


def _busy(kernels) -> Tuple[float, List[Tuple[float, float]]]:
    """Union of the kernel intervals (us) and the gaps between them."""
    busy, gaps, last = 0.0, [], None
    for _, start, end in kernels:
        if last is None:
            busy, last = end - start, end
            continue
        if start > last:
            gaps.append((last, start))
        if end > last:
            busy += end - max(start, last)
            last = end
    return busy, gaps


def _host_at(host, t: float) -> str:
    """The innermost host op running at time ``t`` (the latest to start);
    "python" where none but the profiler's own step range covers it."""
    best: Optional[Tuple[float, str]] = None
    for name, start, end in host:
        if (start <= t <= end and not name.startswith("ProfilerStep")
                and (best is None or start > best[0])):
            best = (start, name)
    return best[1] if best else "python"


def summarise(rec: dict) -> dict:
    """Per-unit device numbers of a profile: busy and span (s), kernels,
    device ms by category and by kernel name, the top device ops and the
    longest idle gaps (breakdown)."""
    kernels = rec["kernels"]
    if not kernels:
        return {"units": rec["units"], "kernels": 0}
    span_us = max(k[2] for k in kernels) - kernels[0][1]
    busy_us, gaps = _busy(kernels)
    by_name: Dict[str, float] = {}
    for name, start, end in kernels:
        by_name[name] = by_name.get(name, 0.0) + (end - start)
    by_cat: Dict[str, float] = {}
    for name, us in by_name.items():
        by_cat[category(name)] = by_cat.get(category(name), 0.0) + us
    counts: Dict[str, int] = {}
    for name, _, _ in kernels:
        counts[name] = counts.get(name, 0) + 1
    units = rec["units"]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    long_gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    return {
        "units": units, "kernels": len(kernels),
        "launches": sum(1 for name, _, _ in kernels if is_launch(name)),
        "busy_s": busy_us / 1e6,
        "span_s": span_us / 1e6, "host_s": rec["host_s"], "read_s": rec["read_s"],
        "ms_by_category": {c: us / 1e3 / units for c, us in by_cat.items()},
        "ms_by_name": {n: us / 1e3 / units for n, us in by_name.items()},
        "count_by_name": counts,
        "breakdown": {
            "device_ops": [[n[:160], us / 1e6] for n, us in top],
            "idle_gaps": [[_host_at(rec["host"], (a + b) / 2)[:160], (b - a) / 1e6]
                          for a, b in long_gaps],
        },
    }
