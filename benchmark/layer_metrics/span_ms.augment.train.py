"""Device ms a traced step spent in the program's ``css.augment`` span (its
CUDA events on the step's stream; ``benchmark/program_spans.py``)."""

from benchmark.program_spans import per_step


def read(record):
    return per_step(record, "css.augment", "device_ms")
