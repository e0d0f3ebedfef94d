"""Label one-hot encodings with the reference's ignore-pixel semantics
(``css_tpu/ops/onehot.py``):

* ``label_onehot`` clamps ignore (-1) to class 0, and the validity mask
  removes those pixels downstream;
* ``label_onehot_ignore`` encodes any label below 0 as an all-zero row (the
  ``mix`` strategy's unlabeled contrastive labels)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["label_onehot", "label_onehot_ignore"]


def label_onehot(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """[..., H, W] int labels -> [..., H, W, C] f32; -1 maps to class 0."""
    return F.one_hot(labels.clamp_min(0).long(), num_classes).float()


def label_onehot_ignore(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """[..., H, W] int labels -> [..., H, W, C] f32; a label < 0 -> all-zero."""
    return label_onehot(labels, num_classes) * (labels >= 0)[..., None]
