"""Device ms a traced step spent in the program's ``css.decoder`` span
(SegFormer's all-MLP decoder, its fuse, the classifier and the
representation head, summed over the teacher's and the student's forwards;
``benchmark/program_spans.py``); None where the program has no such span."""

from benchmark.program_spans import per_step


def read(record):
    return per_step(record, "css.decoder", "device_ms")
