"""Batched geometric augmentation (scale / reflect-pad / crop / flip), float
path, counterpart of ``css_tpu/ops/augment.py``.

Images travel channel-first, [B, 3, H, W] in [0, 1]; label maps [B, K, H, W]
(int, -1 = ignore) and confidence maps [B, L, H, W] ride along.  Each image's
scale ratio and crop-offset uniforms arrive as tensors.

The scale -> reflect-pad -> crop chain is separable, so each axis becomes one
dense [out, in] resample matrix per image carrying PIL BILINEAR's exact
triangle weights (antialiased on downscale), contracted with bf16 operands
and f32 accumulation as the JAX package does.  Labels and confidences are
nearest-sampled; padding gives -1 labels and 0 confidences.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from css_tpu_torch.ops.photometric import random_photometric

__all__ = ["apply_geometric", "batch_transform", "normalize_imagenet",
           "to_channel_first", "to_channel_last"]

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def to_channel_first(img_nhwc: torch.Tensor) -> torch.Tensor:
    return img_nhwc.permute(0, 3, 1, 2)


def to_channel_last(img_nchw: torch.Tensor) -> torch.Tensor:
    return img_nchw.permute(0, 2, 3, 1)


def normalize_imagenet(img_cf: torch.Tensor) -> torch.Tensor:
    """(x - mean) / std over the channel axis of a [B, 3, H, W] batch."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=img_cf.dtype, device=img_cf.device)
    std = torch.tensor(IMAGENET_STD, dtype=img_cf.dtype, device=img_cf.device)
    return (img_cf - mean.reshape(3, 1, 1)) / std.reshape(3, 1, 1)


def _reflect_index(idx: torch.Tensor, size: torch.Tensor) -> torch.Tensor:
    """Multi-fold reflect (no edge repeat), numpy 'reflect' style."""
    period = torch.clamp_min(2.0 * (size - 1.0), 1.0)
    m = torch.remainder(idx, period)
    return torch.where(size > 1, torch.minimum(m, period - m), torch.zeros_like(m))


def _axis_maps(u_off, out_size: int, in_size: int, valid, ratio, crop: int):
    """Per-axis backward maps for a batch: resample matrix [B, out, in] f32,
    nearest source index [B, out] and out-of-bounds mask [B, out]."""
    dev = u_off.device
    v = valid.float()[:, None]                               # [B, 1]
    r = torch.clamp_min(torch.floor(v * ratio[:, None]), 1.0)  # resized extent
    p = torch.clamp_min(r, float(crop))                      # padded extent
    off = torch.floor(u_off[:, None] * (p - crop + 1.0))
    pos = torch.arange(out_size, dtype=torch.float32, device=dev)[None] + off
    oob = pos >= r
    rpos = _reflect_index(pos, r)
    scale = v / r                                            # source / resized
    fs = torch.clamp_min(scale, 1.0)                         # PIL filterscale
    centre = (rpos + 0.5) * scale                            # [B, out]
    j = torch.arange(in_size, dtype=torch.float32, device=dev)
    x = (j[None, None, :] + 0.5 - centre[:, :, None]) / fs[:, :, None]
    mat = torch.clamp_min(1.0 - torch.abs(x), 0.0)           # triangle filter
    mat = torch.where(j[None, None, :] < v[:, :, None], mat, torch.zeros_like(mat))
    mat = mat / torch.clamp_min(mat.sum(dim=2, keepdim=True), 1e-12)
    near = torch.minimum(torch.clamp_min(torch.floor((rpos + 0.5) * scale), 0.0), v - 1.0)
    return mat, near.long(), oob


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """Rounds to bf16 and back: bf16 operands for an f32-accumulated product."""
    return x.to(torch.bfloat16).float()


def apply_geometric(image: torch.Tensor, labels: torch.Tensor, confs: torch.Tensor,
                    valid_hw: torch.Tensor, crop_hw: Tuple[int, int],
                    ratio: torch.Tensor, u_y: torch.Tensor, u_x: torch.Tensor):
    """Scale -> pad (reflect) -> crop with explicit per-image parameters.

    ``image`` [B, 3, H, W] f32, ``labels`` [B, K, H, W] int, ``confs``
    [B, L, H, W] f32, ``valid_hw`` [B, 2] valid canvas extent, ``ratio``,
    ``u_y``, ``u_x`` [B].
    """
    ch, cw = crop_hw
    b, _, h, w = image.shape
    mat_y, ynear, y_oob = _axis_maps(u_y, ch, h, valid_hw[:, 0], ratio, ch)
    mat_x, xnear, x_oob = _axis_maps(u_x, cw, w, valid_hw[:, 1], ratio, cw)

    rows = torch.einsum("boh,bchw->bcow", _bf16(mat_y), _bf16(image))
    out_img = torch.einsum("bpw,bcow->bcop", _bf16(mat_x), _bf16(rows))

    in_pad = (y_oob[:, :, None] | x_oob[:, None, :])[:, None]   # [B, 1, ch, cw]

    def pick(maps, fill):
        k = maps.shape[1]
        maps = torch.gather(maps, 2, ynear[:, None, :, None].expand(b, k, ch, w))
        maps = torch.gather(maps, 3, xnear[:, None, None, :].expand(b, k, ch, cw))
        return torch.where(in_pad, torch.full_like(maps, fill), maps)

    return out_img, pick(labels, -1), pick(confs, 0.0)


def batch_transform(images: torch.Tensor, labels: torch.Tensor, confs: torch.Tensor,
                    valid_hw: torch.Tensor, crop_hw: Tuple[int, int], *,
                    ratio: torch.Tensor, u_y: torch.Tensor, u_x: torch.Tensor,
                    do_jitter: Optional[torch.Tensor] = None,
                    jitter: Optional[torch.Tensor] = None,
                    jitter_order: Optional[torch.Tensor] = None,
                    do_blur: Optional[torch.Tensor] = None,
                    sigma: Optional[torch.Tensor] = None,
                    do_flip: Optional[torch.Tensor] = None):
    """Geometry, then (when the photometric draws are given) jitter, blur and
    a horizontal flip; the reference's ``augmentation=True`` block."""
    img, labels, confs = apply_geometric(images, labels, confs, valid_hw, crop_hw,
                                         ratio, u_y, u_x)
    if do_flip is None:
        return img, labels, confs
    img = random_photometric(img, do_jitter, jitter, jitter_order, do_blur, sigma)
    flip = do_flip.reshape(-1, 1, 1, 1)
    return (torch.where(flip, img.flip(-1), img),
            torch.where(flip, labels.flip(-1), labels),
            torch.where(flip, confs.flip(-1), confs))
