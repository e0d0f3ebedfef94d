"""The port's entry points, counterpart of ``css_tpu/cli/entries.py`` and of
``css_tpu``'s ``evaluate.py`` and ``predict.py``.

    python -m css_tpu_torch.cli.entries ori --synthetic --num_labels 32 \\
        --total_iter 4 --max_steps 4
    python -m css_tpu_torch.cli.entries cross --synthetic --num_labels 16 \\
        --total_iter 4 --warmup 1
    python -m css_tpu_torch.cli.entries evaluate --checkpoint <best_model> --synthetic
    python -m css_tpu_torch.cli.entries predict --checkpoint <best_model> --inputs imgs/

``ori`` is the reference's ``ori_pseudo.py`` (logit-space pseudo-labels),
``mix`` its ``mix_label.py`` (agreement labels) and ``cross`` its
``cross_label.py`` (cross-space supervision after a warmup).  Each runs on
the card unless ``--device cpu`` is given, on ``--num_devices`` devices (one
process each; or as one rank of a ``torchrun`` launch):

    python -m css_tpu_torch.cli.entries ori --num_devices 8
    torchrun --nproc_per_node 8 -m css_tpu_torch.cli.entries ori

``evaluate`` (``cli/evaluate_main.py``) prints a checkpoint's per-class IoU
and mIoU, ``predict`` (``cli/predict_main.py``) writes class maps of
images; both on one device.
"""

from __future__ import annotations

import argparse
import sys

from css_tpu_torch.cli import evaluate_main, predict_main
from css_tpu_torch.cli.train_main import add_common_args, run_training

__all__ = ["ori_pseudo_parser", "ori_pseudo_main", "mix_label_parser", "mix_label_main",
           "cross_label_parser", "cross_label_main", "main"]

_ORI_DOC = """Baseline entry point: logit-space pseudo-labels (reference
ori_pseudo.py), on --num_devices CUDA devices.  CLI-compatible with the
reference script; its --gpu_id/--world_size/--port flags are accepted and
ignored (--num_devices sets the device count)."""

_MIX_DOC = """Mix-label entry point: collaborative (agreement) pseudo-labels
(reference mix_label.py).  Pixels where logit-space and representation-space
labels disagree are ignored; the contrastive hard-anchor probability comes
from the representation space; the contrast weight is ramped down per epoch."""

_CROSS_DOC = """Cross-label entry point: cross-space supervision (reference
cross_label.py).  The unsupervised loss target switches from logit-space to
representation-space pseudo-labels after --warmup epochs; prototypes can be
seeded from another run via --prototypes_resume.  (The reference script
references an undefined --total_iter flag and crashes as shipped; this entry
point defines the flag properly.)"""


def _parser(strategy: str, doc: str, default_job: str) -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog=f"css_tpu_torch.cli.entries {strategy}",
                                     description=doc)
    add_common_args(parser, default_job=default_job)
    # accepted for reference-CLI compatibility and ignored: --num_devices
    # (or torchrun) sets the ranks
    for flag in ("--gpu_id", "--world_size", "--port"):
        parser.add_argument(flag, type=str, default="")
    return parser


def ori_pseudo_parser() -> argparse.ArgumentParser:
    return _parser("ori", _ORI_DOC, "VOC_92_baseline")


def mix_label_parser() -> argparse.ArgumentParser:
    return _parser("mix", _MIX_DOC, "VOC_92_mix_label")


def cross_label_parser() -> argparse.ArgumentParser:
    parser = _parser("cross", _CROSS_DOC, "VOC_92_cross_label")
    parser.add_argument("--warmup", type=int, default=0)
    parser.add_argument("--prototypes_resume", type=str, default="")
    return parser


def ori_pseudo_main(argv=None) -> None:
    print(run_training("ori", ori_pseudo_parser().parse_args(argv)))


def mix_label_main(argv=None) -> None:
    print(run_training("mix", mix_label_parser().parse_args(argv)))


def cross_label_main(argv=None) -> None:
    print(run_training("cross", cross_label_parser().parse_args(argv)))


_MAINS = {"ori": ori_pseudo_main, "mix": mix_label_main, "cross": cross_label_main,
          "evaluate": evaluate_main.main, "predict": predict_main.main}


def main(argv=None) -> None:
    """``<command> [flags]``; the command is a strategy (``ori``, ``mix``,
    ``cross``), ``evaluate`` or ``predict``."""
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] not in _MAINS:
        raise SystemExit("usage: python -m css_tpu_torch.cli.entries "
                         "{ori,mix,cross,evaluate,predict} [flags] (<command> --help lists them)")
    _MAINS[argv[0]](argv[1:])


if __name__ == "__main__":
    main()
