"""CutOut, CutMix and ClassMix, counterpart of ``css_tpu/ops/mixing.py``.

The box geometry is the reference's ``generate_cutout_mask``: area H*W/2,
width drawn in [W/2 + 1, W), height round(area / width), corner uniform.
ClassMix keeps a random half of the labels present in each image's first
label map (-1 counts as a label of its own, slot 0).  The draws arrive as
tensors: the box width and the uniforms of its corner (cutout, cutmix), or
one uniform score per label slot and image (classmix).

The partner of local image i is image (i + 1) mod B (``roll(-1)``) on one
device.  Across ranks (``distributed``) the partner modes are JAX's:

* ``reference``: every rank mixes with rank 0's shard rolled by one (the
  reference gathers the world batch and indexes it with the local batch
  size, so its partners all come from rank 0): one broadcast;
* ``ring``: the global neighbour (i + 1) mod (world * B): the local roll,
  with the last image's partner the next rank's first image (one
  all-gather of one image).

At world size 1 both are the local roll.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

__all__ = ["MIX_MODES", "PARTNERS", "cutout_box_mask", "class_half_mask", "mix_batch"]

MIX_MODES = ("none", "cutout", "cutmix", "classmix")
PARTNERS = ("reference", "ring")


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


def class_half_mask(labels: torch.Tensor, scores: torch.Tensor) -> torch.Tensor:
    """[B, H, W] f32 masks, 1 on the pixels of a random half of each image's
    present labels.  ``labels`` [B, H, W] int in [-1, C); ``scores`` [B, C+1]
    uniforms, slot 0 for label -1.  The present slots are ranked by score and
    those of rank < n_present // 2 kept."""
    slot = (labels + 1).reshape(scores.shape[0], -1).long()              # [B, HW]
    present = scores.new_zeros(scores.shape).scatter_(1, slot, 1.0) > 0
    n_present = present.sum(dim=1, keepdim=True)
    order = torch.argsort(torch.where(present, scores, torch.inf), dim=1, stable=True)
    rank = torch.argsort(order, dim=1)
    selected = present & (rank < n_present // 2)
    return torch.gather(selected.float(), 1, slot).reshape(labels.shape)


@torch.no_grad()
def _partner_batch(x: torch.Tensor, distributed: bool, partner: str) -> torch.Tensor:
    """p with p[i] the mixing partner of local image i."""
    if partner not in PARTNERS:
        raise ValueError(f"unknown partner mode {partner!r} (one of {PARTNERS})")
    if not distributed:
        return torch.roll(x, -1, dims=0)
    if partner == "reference":
        src = x.contiguous().clone()     # rank 0 sends a copy, never its own tensor
        dist.broadcast(src, 0)
        return torch.roll(src, -1, dims=0)
    world, rank = dist.get_world_size(), dist.get_rank()
    firsts = [torch.empty_like(x[:1]) for _ in range(world)]
    dist.all_gather(firsts, x[:1].contiguous())
    rolled = torch.roll(x, -1, dims=0)
    rolled[-1] = firsts[(rank + 1) % world][0]
    return rolled


def mix_batch(images: torch.Tensor, labels: torch.Tensor, confs: torch.Tensor, *,
              mode: str = "cutmix", cut_w: Optional[torch.Tensor] = None,
              u_x: Optional[torch.Tensor] = None, u_y: Optional[torch.Tensor] = None,
              scores: Optional[torch.Tensor] = None, distributed: bool = False,
              partner: str = "reference"):
    """Mixes ``images`` [B, 3, H, W], ``labels`` [B, K, H, W] int and
    ``confs`` [B, L, H, W] as ``mode`` says:

    * none: unchanged;
    * cutout: image and confidences zeroed in the box, and only the first
      label map set to -1 there;
    * cutmix: the box taken from the partner image;
    * classmix: the pixels of a random half of the first label map's classes
      kept, the rest taken from the partner image.

    ``distributed``/``partner`` choose the partners across ranks (see the
    module docstring).
    """
    if mode == "none":
        return images, labels, confs
    if mode in ("cutout", "cutmix"):
        mask = cutout_box_mask(images.shape[2:], cut_w, u_x, u_y)[:, None]
    elif mode == "classmix":
        mask = class_half_mask(labels[:, 0], scores)[:, None]
    else:
        raise ValueError(f"unknown mix mode {mode}")
    if mode == "cutout":
        first = torch.where(mask[:, 0] > 0, labels[:, 0], torch.full_like(labels[:, 0], -1))
        return images * mask, torch.cat([first[:, None], labels[:, 1:]], dim=1), confs * mask
    p_images, p_labels, p_confs = (_partner_batch(t, distributed, partner)
                                   for t in (images, labels, confs))
    im = mask.to(labels.dtype)
    return (images * mask + p_images * (1.0 - mask),
            labels * im + p_labels * (1 - im),
            confs * mask + p_confs * (1.0 - mask))
