"""Profiling, step timing and the train step's spans, counterpart of
``css_tpu/utils/profiling.py``.

``maybe_profile`` wraps a region in ``torch.profiler`` when a directory is
given and writes a Chrome trace there (open it in Perfetto or
chrome://tracing); ``StepTimer`` is a steps/s meter for the train loop.

``span(name)`` marks a phase of the program.  It records only while
``torch.profiler`` is recording or inside ``tracing()``; otherwise it returns
one shared no-op context and does nothing else.  A recorded span keeps

* a ``torch.profiler.record_function`` range of its name, so the phase sits
  on the device trace's clock and names the host time inside it;
* its host ``perf_counter`` interval;
* with ``device=True`` and CUDA in use, a pair of CUDA events on the current
  stream, read by ``snapshot()`` after one synchronisation, never sooner;
* its parent, the innermost span open on the same thread when it opened;
* the synchronising CUDA calls made while it is the innermost open span:
  while any span is open, ``torch.cuda.set_sync_debug_mode("warn")`` is on
  and a warnings hook counts every such warning (the default filter would
  show each call site once) instead of printing it; the mode, the filters
  and the hook are restored when the last open span closes.

``snapshot()`` sums the spans closed so far by name; ``reset()`` drops them.

``cut_at_spans(cut)`` serves a CUDA graph capture (``train/graph_step.py``):
inside it, on its thread, ``span`` records nothing and calls ``cut(edge)``
at each edge instead, ``("enter", name, device)`` and ``("exit",)``, so that
the capture can end one graph there and begin the next; a replay then opens
and closes the spans between the graphs' launches.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
import warnings
from typing import Dict, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

__all__ = ["maybe_profile", "StepTimer", "span", "tracing", "snapshot", "reset",
           "per_step_line", "cut_at_spans"]

_SYNC_WARNING = "called a synchronizing CUDA operation"   # c10's text, under "warn"


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


class _Span:
    """One recorded span, open or closed."""

    __slots__ = ("name", "device", "parent", "syncs", "host_ms", "device_ms", "_t0", "_events",
                 "_range")

    def __init__(self, name: str, device: bool):
        self.name, self.device = name, device
        self.syncs = 0
        self.host_ms = 0.0
        self.device_ms: Optional[float] = None
        self._events = None

    def __enter__(self):
        _RECORDER.open(self)
        return self

    def __exit__(self, *exc):
        _RECORDER.close(self)
        return False


class _Recorder:
    """The closed spans, each thread's stack of open ones, and the sync
    counter's saved settings while any span is open."""

    def __init__(self):
        self.forced = 0
        self.closed = []
        self._local = threading.local()
        self._lock = threading.Lock()
        self._open = 0
        self._saved = None

    def stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def open(self, sp: _Span) -> None:
        stack = self.stack()
        sp.parent = stack[-1] if stack else None
        with self._lock:
            if self._open == 0:
                self._saved = self._count_syncs()
            self._open += 1
        stack.append(sp)
        sp._range = torch.profiler.record_function(sp.name)
        sp._range.__enter__()
        if sp.device and torch.cuda.is_initialized():
            sp._events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            sp._events[0].record()
        sp._t0 = time.perf_counter()

    def close(self, sp: _Span) -> None:
        sp.host_ms = (time.perf_counter() - sp._t0) * 1e3
        if sp._events is not None:
            sp._events[1].record()
        sp._range.__exit__(None, None, None)
        self.stack().pop()
        self.closed.append(sp)
        with self._lock:
            self._open -= 1
            if self._open == 0:
                self._restore(self._saved)

    def _show(self, message, category, filename, lineno, file=None, line=None):
        if str(message).startswith(_SYNC_WARNING):
            stack = self.stack()
            if stack:
                stack[-1].syncs += 1
            return
        self._saved[2](message, category, filename, lineno, file, line)

    def _count_syncs(self):
        mode = None
        if torch.cuda.is_initialized():
            mode = torch.cuda.get_sync_debug_mode()
            with warnings.catch_warnings():     # torch's note that the mode is a prototype
                warnings.simplefilter("ignore")
                torch.cuda.set_sync_debug_mode("warn")
        warnings.filterwarnings("always", message=_SYNC_WARNING)
        saved = (mode, warnings.filters[0], warnings.showwarning)
        warnings.showwarning = self._show
        return saved

    @staticmethod
    def _restore(saved) -> None:
        mode, entry, show = saved
        warnings.showwarning = show
        with contextlib.suppress(ValueError):
            warnings.filters.remove(entry)
        if mode is not None:
            torch.cuda.set_sync_debug_mode(mode)


_RECORDER = _Recorder()
_OFF = contextlib.nullcontext()
_CUTS = threading.local()       # .cut: the capture's callable while one runs on the thread


class _Cut:
    """A span met while a graph capture runs: its edges call the capture's
    ``cut``; an edge that an exception crosses calls nothing."""

    __slots__ = ("name", "device", "cut")

    def __init__(self, name: str, device: bool, cut):
        self.name, self.device, self.cut = name, device, cut

    def __enter__(self):
        self.cut(("enter", self.name, self.device))
        return self

    def __exit__(self, exc_type, *exc):
        if exc_type is None:
            self.cut(("exit",))
        return False


def span(name: str, device: bool = True):
    """A context that records the phase ``name`` while tracing is on (see the
    module's docstring); ``device=False`` keeps no CUDA events (a host-only
    phase).  Off, the one shared no-op context; inside ``cut_at_spans``, a
    context that cuts the capture at its edges."""
    cut = getattr(_CUTS, "cut", None)
    if cut is not None:
        return _Cut(name, device, cut)
    if not (_RECORDER.forced or _autograd_profiler._is_profiler_enabled):
        return _OFF
    return _Span(name, device)


@contextlib.contextmanager
def cut_at_spans(cut):
    """Inside, on this thread, each span's edges call ``cut(edge)`` in place
    of recording (see the module's docstring)."""
    outer = getattr(_CUTS, "cut", None)
    _CUTS.cut = cut
    try:
        yield
    finally:
        _CUTS.cut = outer


@contextlib.contextmanager
def tracing():
    """Spans record inside this block without ``torch.profiler``."""
    _RECORDER.forced += 1
    try:
        yield
    finally:
        _RECORDER.forced -= 1


def reset() -> None:
    """Drops the spans closed so far."""
    _RECORDER.closed = []


def snapshot() -> Dict[str, dict]:
    """``{name: {count, host_ms, device_ms, self_ms, syncs, parent}}`` over
    the spans closed since the last ``reset()``: sums over a name's spans;
    ``device_ms`` None for a name without CUDA events; ``self_ms`` a span's
    time less its child spans' on the same clock (device where it has
    events, else host); ``parent`` the name of the first span's parent.
    Synchronises the card once if an event is still unread."""
    spans = list(_RECORDER.closed)
    pending = [s for s in spans if s._events is not None]
    if pending:
        torch.cuda.synchronize()
        for s in pending:
            s.device_ms = s._events[0].elapsed_time(s._events[1])
            s._events = None
    kids: Dict[int, list] = {}
    for s in spans:
        if s.parent is not None:
            kids.setdefault(id(s.parent), []).append(s)
    out: Dict[str, dict] = {}
    for s in spans:
        below = kids.get(id(s), [])
        if s.device_ms is not None:
            own = s.device_ms - sum(k.device_ms for k in below if k.device_ms is not None)
        else:
            own = s.host_ms - sum(k.host_ms for k in below)
        e = out.setdefault(s.name, {"count": 0, "host_ms": 0.0, "device_ms": None,
                                    "self_ms": 0.0, "syncs": 0,
                                    "parent": s.parent.name if s.parent else None})
        e["count"] += 1
        e["host_ms"] += s.host_ms
        if s.device_ms is not None:
            e["device_ms"] = (e["device_ms"] or 0.0) + s.device_ms
        e["self_ms"] += own
        e["syncs"] += s.syncs
    return out


def per_step_line(spans: Dict[str, dict]) -> str:
    """Each span's device ms, host ms and syncs a step (a ``css.step``) of
    ``snapshot()``, for a log line; empty without steps."""
    steps = spans.get("css.step", {}).get("count", 0)
    if not steps:
        return ""
    parts = []
    for name, e in spans.items():
        dev = "-" if e["device_ms"] is None else f"{e['device_ms'] / steps:.3f}"
        parts.append(f"{name} {dev}/{e['host_ms'] / steps:.3f}/{e['syncs'] / steps:g}")
    return f"spans a step over {steps} (device ms/host ms/syncs): " + ", ".join(parts)
