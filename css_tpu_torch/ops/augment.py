"""Batched geometric augmentation (scale / reflect-pad / crop / flip),
counterpart of ``css_tpu/ops/augment.py``.

Images travel channel-first, [B, 3, H, W] in [0, 1]; label maps [B, K, H, W]
(int, -1 = ignore) and confidence maps [B, L, H, W] ride along.  Each image's
scale ratio and crop-offset uniforms arrive as tensors.

The scale -> reflect-pad -> crop chain is separable, so each axis becomes one
dense [out, in] resample matrix per image carrying PIL BILINEAR's exact
triangle weights (antialiased on downscale), contracted with bf16 operands
and f32 accumulation as the JAX package does.  Labels and confidences are
nearest-sampled; padding gives -1 labels and 0 confidences.

``quantize=True`` is the reference's uint8 law: the tensor-to-PIL entry hop
truncates the image (through the f32 normalize round trip) and the
confidences to the uint8 grid, and the image is resampled by PIL's 8-bit
fixed-point law (``_fixed_point_resample``) instead of the bf16 product;
the photometric ops take their uint8 laws too.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from css_tpu_torch.ops.photometric import (device_constant, exact_div, q8_entry_image,
                                           q8_floor, random_photometric)

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
    mean = device_constant(IMAGENET_MEAN, img_cf.dtype, img_cf.device)
    std = device_constant(IMAGENET_STD, img_cf.dtype, img_cf.device)
    return (img_cf - mean.reshape(3, 1, 1)) / std.reshape(3, 1, 1)


def _reflect_index(idx: torch.Tensor, size: torch.Tensor) -> torch.Tensor:
    """Multi-fold reflect (no edge repeat), numpy 'reflect' style."""
    period = torch.clamp_min(2.0 * (size - 1.0), 1.0)
    m = torch.remainder(idx, period)
    return torch.where(size > 1, torch.minimum(m, period - m), torch.zeros_like(m))


_WINDOW = 32


def _row_sum_xla_order(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last dim in the order of XLA's CPU reduce, which the JAX
    package's weights are normalised with: the row zero-padded to a multiple
    of 32 (the smaller half of the padding in front), each 32-wide window
    summed left to right, and the window sums again so while more than 32,
    then left to right.  Explicit elementwise adds, so the card and the CPU
    give the same bits."""
    while x.shape[-1] > _WINDOW:
        n = x.shape[-1]
        pad = -n % _WINDOW
        x = torch.nn.functional.pad(x, (pad // 2, pad - pad // 2))
        x = x.reshape(*x.shape[:-1], -1, _WINDOW)
        x = _sequential_sum(x)
    return _sequential_sum(x)


def _sequential_sum(x: torch.Tensor) -> torch.Tensor:
    s = x[..., 0]
    for i in range(1, x.shape[-1]):
        s = s + x[..., i]
    return s


def _axis_maps(u_off, out_size: int, in_size: int, valid, ratio, crop: int,
               xla_order: bool = False):
    """Per-axis backward maps for a batch: resample matrix [B, out, in] f32,
    nearest source index [B, out] and out-of-bounds mask [B, out].
    ``xla_order``: the rows are normalised by sums in the JAX package's
    order, so that the uint8 law's coefficients ``floor(w 2^22 + 0.5)``
    come out the same to the last bit."""
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
    total = _row_sum_xla_order(mat)[..., None] if xla_order else mat.sum(dim=2, keepdim=True)
    mat = mat / torch.clamp_min(total, 1e-12)
    near = torch.minimum(torch.clamp_min(torch.floor((rpos + 0.5) * scale), 0.0), v - 1.0)
    return mat, near.long(), oob


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """Rounds to bf16 and back: bf16 operands for an f32-accumulated product."""
    return x.to(torch.bfloat16).float()


_PB = 22   # PIL's PRECISION_BITS for 8-bit channels


def _fixed_point_pass(mat: torch.Tensor, img: torch.Tensor, spec: str) -> torch.Tensor:
    """One pass of PIL's 8-bit resample: coefficients ``floor(w 2^22 + 0.5)``
    from the f32 weights, the sum seeded with 2^21, ``>> 22``, clipped to
    0..255.  The product is taken in f64, where every partial sum (below
    2^41) is an exact integer whatever the order or the device's matmul
    flags: the integers the JAX package gets from its hi/lo split."""
    k = torch.floor(mat * float(1 << _PB) + 0.5)
    s = torch.einsum(spec, k.double(), img.double())
    return torch.clamp(torch.floor((s + (1 << (_PB - 1))) / (1 << _PB)), 0, 255).float()


def _fixed_point_resample(img255: torch.Tensor, mat_x: torch.Tensor,
                          mat_y: torch.Tensor) -> torch.Tensor:
    """PIL's 8-bit fixed-point resample of [B, 3, H, W] 0..255 images: the
    horizontal pass first, each pass emitting a uint8 image."""
    rows = _fixed_point_pass(mat_x, img255, "bpw,bchw->bchp")
    return _fixed_point_pass(mat_y, rows, "boh,bchp->bcop")


def apply_geometric(image: torch.Tensor, labels: torch.Tensor, confs: torch.Tensor,
                    valid_hw: torch.Tensor, crop_hw: Tuple[int, int],
                    ratio: torch.Tensor, u_y: torch.Tensor, u_x: torch.Tensor,
                    quantize: bool = False):
    """Scale -> pad (reflect) -> crop with explicit per-image parameters.

    ``image`` [B, 3, H, W] f32, ``labels`` [B, K, H, W] int, ``confs``
    [B, L, H, W] f32, ``valid_hw`` [B, 2] valid canvas extent, ``ratio``,
    ``u_y``, ``u_x`` [B]; ``quantize``: the uint8 law.
    """
    ch, cw = crop_hw
    b, _, h, w = image.shape
    if quantize:
        image, confs = q8_entry_image(image), q8_floor(confs)
    mat_y, ynear, y_oob = _axis_maps(u_y, ch, h, valid_hw[:, 0], ratio, ch, quantize)
    mat_x, xnear, x_oob = _axis_maps(u_x, cw, w, valid_hw[:, 1], ratio, cw, quantize)

    if quantize:
        out_img = exact_div(_fixed_point_resample(torch.floor(image * 255.0 + 0.5), mat_x, mat_y),
                            255.0)
    else:
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
                    do_flip: Optional[torch.Tensor] = None,
                    quantize: bool = False):
    """Geometry, then (when the photometric draws are given) jitter, blur and
    a horizontal flip; the reference's ``augmentation=True`` block.
    ``quantize``: the uint8 law at every hop."""
    img, labels, confs = apply_geometric(images, labels, confs, valid_hw, crop_hw,
                                         ratio, u_y, u_x, quantize)
    if do_flip is None:
        return img, labels, confs
    img = random_photometric(img, do_jitter, jitter, jitter_order, do_blur, sigma, quantize)
    flip = do_flip.reshape(-1, 1, 1, 1)
    return (torch.where(flip, img.flip(-1), img),
            torch.where(flip, labels.flip(-1), labels),
            torch.where(flip, confs.flip(-1), confs))
