"""Peaks of the card, model FLOPs from shapes, and kernel byte bounds.

Peaks: NVIDIA's data sheet for the H100 SXM (dense, no sparsity), which
assumes the card's full 700 W; the run records the card's power limit.
FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` over one forward of
the reference network (``reference/networks/<Network.name>.py``) on the
meta device, so nothing is computed: convolutions and matrix products at 2
FLOPs a multiply-add, nothing else.
"""

from __future__ import annotations

import functools
import json

import torch

__all__ = ["BF16_FLOP_PER_S", "HBM_BYTES_PER_S", "forward_flops", "train_step_flops",
           "class_live_rows_bytes"]

BF16_FLOP_PER_S = 989e12
HBM_BYTES_PER_S = 3.35e12


@functools.lru_cache(maxsize=8)
def _forward_flops(network_json: str, h: int, w: int) -> int:
    from torch.utils.flop_counter import FlopCounterMode

    from benchmark.reference.model import build_reference

    model = build_reference({"Network": json.loads(network_json)}, device="meta").eval()
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        model(torch.empty((1, h, w, 3), device="meta"))
    return int(counter.get_total_flops())


def forward_flops(config: dict, hw) -> int:
    """FLOPs of one image's forward at ``hw``."""
    return _forward_flops(json.dumps(config["Network"], sort_keys=True), int(hw[0]), int(hw[1]))


def train_step_flops(config: dict, crop, l_batch: int, u_batch: int) -> int:
    """Model FLOPs of one ``ori`` step: the student's forward and backward
    (x3) on both batches and the teacher's forward on the unlabeled one."""
    f = forward_flops(config, crop)
    return 3 * (l_batch + u_batch) * f + u_batch * f


def class_live_rows_bytes(num_classes: int, rows: int) -> int:
    """The inputs of ``class_live_rows_kernel`` read once: the thinning
    uniforms [C, N] f32, the rows' classes [N] int32 and the weights
    [C, C + 1] f32 (the live rows it writes, about 0.4% more, left out)."""
    return num_classes * rows * 4 + rows * 4 + num_classes * (num_classes + 1) * 4
