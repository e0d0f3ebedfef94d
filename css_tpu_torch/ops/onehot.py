"""Label one-hot encoding with the reference's ignore-pixel semantics
(``css_tpu/ops/onehot.py``): ignore (-1) is clamped to class 0, and the
validity mask removes those pixels downstream."""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["label_onehot"]


def label_onehot(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """[..., H, W] int labels -> [..., H, W, C] f32; -1 maps to class 0."""
    return F.one_hot(labels.clamp_min(0).long(), num_classes).float()
