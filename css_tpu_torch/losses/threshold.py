"""Confidence-weighted unsupervised CE, counterpart of
``css_tpu/losses/threshold.py`` (the reference's Attention_Threshold_Loss).

Per image, weight = #(confidence >= threshold) / #(valid pseudo-labels),
defined as 0 for an image with no valid pseudo-label; the weighted per-pixel
CE is averaged over its strictly positive entries.
"""

from __future__ import annotations

import torch

from css_tpu_torch.losses.cross_entropy import per_pixel_cross_entropy

__all__ = ["attention_threshold_loss"]


def attention_threshold_loss(logits: torch.Tensor, pseudo_labels: torch.Tensor,
                             confidence: torch.Tensor,
                             strong_threshold: float = 0.97) -> torch.Tensor:
    """``logits`` [B, H, W, C], ``pseudo_labels`` [B, H, W] (-1 = ignore),
    ``confidence`` [B, H, W] teacher max-softmax."""
    b = logits.shape[0]
    valid = (pseudo_labels >= 0).reshape(b, -1).float()
    confident = (confidence >= strong_threshold).reshape(b, -1).float()
    denom = valid.sum(-1)
    weight = torch.where(denom > 0, confident.sum(-1) / denom.clamp_min(1.0),
                         torch.zeros_like(denom))
    nll = per_pixel_cross_entropy(logits, pseudo_labels)
    pos = (nll > 0).float()
    total_pos = pos.sum()
    loss = (weight[:, None, None] * nll * pos).sum() / total_pos.clamp_min(1.0)
    return torch.where(total_pos > 0, loss, torch.zeros_like(loss))
