"""The port's training entry point, counterpart of ``css_tpu/cli/entries.py``.

    python -m css_tpu_torch.cli.entries ori --synthetic --num_labels 32 \\
        --total_iter 4 --max_steps 4

``ori`` is the reference's ``ori_pseudo.py``: logit-space pseudo-labels.  It
runs on the card unless ``--device cpu`` is given.  The strategies ``mix``
and ``cross`` are not ported yet.
"""

from __future__ import annotations

import argparse
import sys

from css_tpu_torch.cli.train_main import add_common_args, run_training

__all__ = ["ori_pseudo_parser", "ori_pseudo_main", "main"]

_ORI_DOC = """Baseline entry point: logit-space pseudo-labels (reference
ori_pseudo.py), on one CUDA device.  CLI-compatible with the reference script;
its --gpu_id/--world_size/--port flags are accepted and ignored."""


def _legacy_dist_flags(parser):
    # accepted for reference-CLI compatibility; the port runs one device
    parser.add_argument("--gpu_id", type=str, default="")
    parser.add_argument("--world_size", type=str, default="")
    parser.add_argument("--port", type=str, default="")


def ori_pseudo_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="css_tpu_torch.cli.entries ori", description=_ORI_DOC)
    add_common_args(parser, default_job="VOC_92_baseline")
    _legacy_dist_flags(parser)
    return parser


def ori_pseudo_main(argv=None) -> None:
    print(run_training("ori", ori_pseudo_parser().parse_args(argv)))


def main(argv=None) -> None:
    """``<strategy> [flags]``; the strategy is ``ori``."""
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] not in ("ori", "mix", "cross"):
        raise SystemExit("usage: python -m css_tpu_torch.cli.entries ori [flags] "
                         "(ori --help lists them)")
    if argv[0] != "ori":
        raise NotImplementedError(f"strategy {argv[0]!r} is not ported to css_tpu_torch yet "
                                  "(item 12)")
    ori_pseudo_main(argv[1:])


if __name__ == "__main__":
    main()
