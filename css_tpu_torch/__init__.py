"""PyTorch/CUDA port of css_tpu for NVIDIA Hopper.

Mirrors the module layout of ``css_tpu``: the same semi-supervised
segmentation framework (DeepLabV3+ student, EMA teacher, pseudo-labels,
pixel-prototype contrastive loss), with the Pallas TPU kernels rewritten as
CUDA kernels for ``sm_90a``.  Imports ``torch`` only; never JAX.

Entry points run on the card (``device="cuda"``) unless the caller asks for
the CPU explicitly.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises for CUDA when no GPU is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("css_tpu_torch: no CUDA device is available; "
                           "pass device='cpu' to run on the CPU")
    return dev
