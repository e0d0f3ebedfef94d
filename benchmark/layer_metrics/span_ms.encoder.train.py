"""Device ms a traced step spent in the program's ``css.encoder`` span (a
SegFormer trunk's forward: patch embeddings, blocks and stage norms, its
CUDA events on the step's stream, summed over the teacher's and the
student's forwards; ``benchmark/program_spans.py``); None where the program
has no such span."""

from benchmark.program_spans import per_step


def read(record):
    return per_step(record, "css.encoder", "device_ms")
