"""Host ms a traced step's consumer waited on the program's decode pool: its
``css.loader`` span, both loaders (``benchmark/program_spans.py``)."""

from benchmark.program_spans import per_step


def read(record):
    return per_step(record, "css.loader", "host_ms")
