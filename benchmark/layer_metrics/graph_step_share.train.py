"""Share of the traced steps that ran as CUDA graph replays: the count of the
program's ``css.graph`` span (entered once a step on the graph path, never on
the eager one) over that of ``css.step`` (``benchmark/program_spans.py``).
None where no spans were recorded; 0 on a program without the graph path."""

from benchmark.program_spans import STEP, spans


def read(record):
    s = spans() if record["kind"] == "train" else None
    if s is None:
        return None
    return s.get("css.graph", {}).get("count", 0) / s[STEP]["count"]
