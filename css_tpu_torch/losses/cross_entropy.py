"""Cross-entropy with ignore-index -1 over NHWC logits, counterpart of
``css_tpu/losses/cross_entropy.py`` (the OHEM variant is not ported yet)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["cross_entropy", "per_pixel_cross_entropy"]


def per_pixel_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-pixel CE in f32; entries with label < 0 are 0.
    ``logits`` [..., C], ``labels`` [...] int."""
    valid = labels >= 0
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, labels.clamp_min(0).long()[..., None])[..., 0]
    return torch.where(valid, nll, torch.zeros_like(nll))


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean CE over valid (label >= 0) pixels; 0 if nothing is valid."""
    valid = (labels >= 0).float()
    return per_pixel_cross_entropy(logits, labels).sum() / valid.sum().clamp_min(1.0)
