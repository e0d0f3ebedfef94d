"""CutMix on one device, counterpart of ``css_tpu/ops/mixing.py``.

The box geometry is the reference's ``generate_cutout_mask``: area H*W/2,
width drawn in [W/2 + 1, W), height round(area / width), corner uniform.
The partner of image i is image (i + 1) mod B (``roll(-1)``).  The draws
(width, and the uniforms of the corner) arrive as tensors.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["cutout_box_mask", "mix_batch"]


def cutout_box_mask(hw: Tuple[int, int], cut_w: torch.Tensor, u_x: torch.Tensor,
                    u_y: torch.Tensor, ratio: int = 2) -> torch.Tensor:
    """[B, H, W] f32 masks: 0 inside each image's box, 1 outside.
    ``cut_w`` [B] int widths; ``u_x``, ``u_y`` [B] uniforms for the corner."""
    h, w = hw
    cut_wf = cut_w.float()
    cut_h = torch.round(torch.full_like(cut_wf, h * w / ratio) / cut_wf)
    x0 = torch.floor(u_x * (w - cut_wf + 1.0))
    y0 = torch.floor(u_y * (h - cut_h + 1.0))
    yy = torch.arange(h, dtype=torch.float32, device=cut_w.device)[None, :, None]
    xx = torch.arange(w, dtype=torch.float32, device=cut_w.device)[None, None, :]
    inside = ((yy >= y0[:, None, None]) & (yy < (y0 + cut_h)[:, None, None])
              & (xx >= x0[:, None, None]) & (xx < (x0 + cut_wf)[:, None, None]))
    return torch.where(inside, 0.0, 1.0)


def mix_batch(images: torch.Tensor, labels: torch.Tensor, confs: torch.Tensor, *,
              cut_w: torch.Tensor, u_x: torch.Tensor, u_y: torch.Tensor):
    """CutMix each image with its partner; ``images`` [B, 3, H, W],
    ``labels`` [B, K, H, W] int, ``confs`` [B, L, H, W]."""
    mask = cutout_box_mask(images.shape[2:], cut_w, u_x, u_y)[:, None]
    p_images, p_labels, p_confs = (torch.roll(t, -1, dims=0) for t in (images, labels, confs))
    im = mask.to(labels.dtype)
    return (images * mask + p_images * (1.0 - mask),
            labels * im + p_labels * (1 - im),
            confs * mask + p_confs * (1.0 - mask))
