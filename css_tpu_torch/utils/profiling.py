"""Profiling and step timing, counterpart of ``css_tpu/utils/profiling.py``.

``maybe_profile`` wraps a region in ``torch.profiler`` when a directory is
given and writes a Chrome trace there (open it in Perfetto or
chrome://tracing); ``StepTimer`` is a steps/s meter for the train loop.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch

__all__ = ["maybe_profile", "StepTimer"]


@contextlib.contextmanager
def maybe_profile(trace_dir: Optional[str], enabled: bool = True):
    if not (trace_dir and enabled):
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    os.makedirs(trace_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(trace_dir, f"trace_{os.getpid()}.json"))


class StepTimer:
    """Host wall time between ticks; the first ``warmup`` intervals are left
    out."""

    def __init__(self, warmup: int = 1):
        self.warmup = warmup
        self.count = 0
        self.total = 0.0
        self._last: Optional[float] = None

    def tick(self) -> None:
        now = time.perf_counter()
        if self._last is not None:
            self.count += 1
            if self.count > self.warmup:
                self.total += now - self._last
        self._last = now

    @property
    def steps_per_sec(self) -> float:
        n = self.count - self.warmup
        return n / self.total if n > 0 and self.total > 0 else 0.0

    def summary(self) -> str:
        sps = self.steps_per_sec
        return f"steps/s {sps:.3f}" if sps else "steps/s n/a"
