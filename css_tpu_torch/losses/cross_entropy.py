"""Cross-entropy with ignore-index -1 over NHWC logits, plain and OHEM,
counterpart of ``css_tpu/losses/cross_entropy.py``.

OHEM's k-th smallest target probability is ``torch.kthvalue``: the exact
order statistic, duplicates counted, as the JAX package's bit bisection
gives it, without a host synchronisation.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["cross_entropy", "per_pixel_cross_entropy", "kth_smallest", "ohem_keep_threshold",
           "ohem_cross_entropy"]


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


def kth_smallest(flat: torch.Tensor, k: int) -> torch.Tensor:
    """The k-th smallest (1-based, duplicates counted) of a 1-D tensor."""
    return torch.kthvalue(flat, k).values


def ohem_keep_threshold(target_prob: torch.Tensor, valid: torch.Tensor, thresh: float,
                        min_kept: int) -> torch.Tensor:
    """The probability at or below which a valid pixel is kept:
    max(k-th smallest target probability, ``thresh``) with k = min(min_kept,
    pixels), invalid pixels ranked as probability 1; +inf (keep every valid
    pixel) when ``min_kept`` exceeds the valid pixels, decided on the device."""
    flat = torch.where(valid, target_prob, torch.ones_like(target_prob)).reshape(-1)
    kth = kth_smallest(flat, min(int(min_kept), flat.numel()))
    keep = torch.clamp_min(kth, thresh)
    return torch.where(valid.sum() < min_kept, torch.full_like(keep, float("inf")), keep)


def ohem_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, thresh: float = 0.7,
                       min_kept: int = 200000) -> torch.Tensor:
    """Online hard-example-mining CE (the reference's
    ``ProbOhemCrossEntropy2d``): the mean CE over the valid pixels whose
    target-class probability is at most ``ohem_keep_threshold``; 0 if none."""
    labels = labels.long()
    valid = labels >= 0
    prob = torch.softmax(logits.float(), dim=-1)
    target_prob = torch.gather(prob, -1, labels.clamp_min(0)[..., None])[..., 0]
    keep = ohem_keep_threshold(target_prob.detach(), valid, thresh, min_kept)
    kept = valid & (target_prob <= keep)
    nll = per_pixel_cross_entropy(logits, torch.where(kept, labels, torch.full_like(labels, -1)))
    return nll.sum() / kept.sum().clamp_min(1)
