"""The program's own spans, a step: what the ``program_span`` readers read.

``css_tpu_torch.utils.profiling.snapshot()`` holds the spans that the traced
steps recorded (the recorder records only under ``torch.profiler``, and the
reference imports nothing of the program).  Each value is a span's sum over
those steps divided by the count of ``css.step``.  ``None`` where the
program has no such recorder, where no ``css.step`` was recorded (an
untraced run), or where the span or its field is missing.
"""

from __future__ import annotations

from typing import Optional

STEP = "css.step"


def spans() -> Optional[dict]:
    try:
        from css_tpu_torch.utils.profiling import snapshot
    except ImportError:         # a program without the recorder
        return None
    s = snapshot()
    return s if s.get(STEP, {}).get("count") else None


def per_step(record: dict, name: str, field: str) -> Optional[float]:
    """``field`` of span ``name``, a step."""
    s = spans() if record["kind"] == "train" else None
    if s is None or s.get(name, {}).get(field) is None:
        return None
    return s[name][field] / s[STEP]["count"]


def syncs_per_step(record: dict, roots=(STEP, "css.draws")) -> Optional[float]:
    """Synchronising CUDA calls a step counted in the spans ``roots`` and in
    every span below them."""
    s = spans() if record["kind"] == "train" else None
    if s is None:
        return None

    def below_a_root(name):
        for _ in range(len(s) + 1):       # a parent chain is shorter than the names
            if name in roots:
                return True
            name = s.get(name, {}).get("parent")
        return False

    return sum(e["syncs"] for n, e in s.items() if below_a_root(n)) / s[STEP]["count"]
