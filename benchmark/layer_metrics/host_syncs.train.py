"""Synchronising CUDA calls a traced step made inside the program's
``css.step`` and ``css.draws`` spans (counted under
``torch.cuda.set_sync_debug_mode("warn")``; ``benchmark/program_spans.py``)."""

from benchmark.program_spans import syncs_per_step


def read(record):
    return syncs_per_step(record)
