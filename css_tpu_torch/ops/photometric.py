"""Batched photometric augmentation (float law), counterpart of
``css_tpu/ops/photometric.py``.

Images are channel-first batches [B, 3, H, W] in [0, 1].  Every random
quantity arrives as a tensor with one entry per image: the jitter flags,
the four factors (brightness, contrast, saturation, hue), the op order (a
permutation of 0..3 per image), the blur flags and sigmas.  The uint8 (PIL
bit-faithful) law is not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["color_jitter", "pil_gaussian_blur", "random_photometric"]

_LUMA = (0.299, 0.587, 0.114)


def _per_image(v: torch.Tensor) -> torch.Tensor:
    return v.reshape(-1, 1, 1, 1)


def _rgb_to_grayscale(img: torch.Tensor) -> torch.Tensor:
    w = torch.tensor(_LUMA, dtype=img.dtype, device=img.device).reshape(1, 3, 1, 1)
    return torch.sum(img * w, dim=1, keepdim=True)


def _rgb_to_hsv(img: torch.Tensor) -> torch.Tensor:
    r, g, b = img.unbind(1)
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    delta = maxc - minc
    safe_delta = torch.where(delta > 0, delta, torch.ones_like(delta))
    s = torch.where(maxc > 0, delta / torch.where(maxc > 0, maxc, torch.ones_like(maxc)),
                    torch.zeros_like(maxc))
    rc = (maxc - r) / safe_delta
    gc = (maxc - g) / safe_delta
    bc = (maxc - b) / safe_delta
    h = torch.where(maxc == r, bc - gc,
                    torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(delta > 0, torch.remainder(h / 6.0, 1.0), torch.zeros_like(h))
    return torch.stack([h, s, maxc], dim=1)


def _hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    h, s, v = hsv.unbind(1)
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - f * s)
    t = v * (1.0 - (1.0 - f) * s)
    sector = torch.remainder(i.long(), 6)[None]
    pick = lambda *vals: torch.gather(torch.stack(vals), 0, sector)[0]  # noqa: E731
    return torch.stack([pick(v, q, p, p, t, v), pick(t, v, v, q, p, p),
                        pick(p, p, t, v, v, q)], dim=1)


def _brightness(x, f):
    return torch.clamp(x * _per_image(f), 0.0, 1.0)


def _contrast(x, f):
    f = _per_image(f)
    mean = _rgb_to_grayscale(x).mean(dim=(1, 2, 3), keepdim=True)
    return torch.clamp(f * x + (1.0 - f) * mean, 0.0, 1.0)


def _saturation(x, f):
    f = _per_image(f)
    return torch.clamp(f * x + (1.0 - f) * _rgb_to_grayscale(x), 0.0, 1.0)


def _hue(x, f):
    hsv = _rgb_to_hsv(torch.clamp(x, 0.0, 1.0))
    h = torch.remainder(hsv[:, 0] + f.reshape(-1, 1, 1), 1.0)
    return _hsv_to_rgb(torch.stack([h, hsv[:, 1], hsv[:, 2]], dim=1))


def color_jitter(img: torch.Tensor, factors: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """``factors`` [B, 4] (brightness, contrast, saturation, hue); ``order``
    [B, 4], each row a permutation of the four ops applied in turn."""
    ops = (_brightness, _contrast, _saturation, _hue)
    for k in range(4):
        idx = _per_image(order[:, k])
        out = img
        for j, op in enumerate(ops):
            out = torch.where(idx == j, op(img, factors[:, j]), out)
        img = out
    return img


def _box_pass(x, a, b, dim):
    pad = (1, 1, 0, 0) if dim == 3 else (0, 0, 1, 1)
    p = F.pad(x, pad, mode="replicate")
    n = x.shape[dim]
    lo, mid, hi = (p.narrow(dim, k, n) for k in range(3))
    return a * (lo + hi) + b * mid


def pil_gaussian_blur(img: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """PIL's GaussianBlur law: three fractional box passes per axis with
    per-pass radius q = sigma^2 / (6 - 2 sigma^2), edge-clamped, horizontal
    passes first.  ``sigma`` [B]."""
    sig2 = torch.clamp(torch.square(sigma), 1e-8, 2.0)
    q = sig2 / (6.0 - 2.0 * sig2)
    a = _per_image(q / (2.0 * q + 1.0))
    b = _per_image(1.0 / (2.0 * q + 1.0))
    for _ in range(3):
        img = _box_pass(img, a, b, 3)
    for _ in range(3):
        img = _box_pass(img, a, b, 2)
    return img


def random_photometric(img, do_jitter, jitter, jitter_order, do_blur, sigma):
    """Jitter where ``do_jitter``, then blur where ``do_blur`` (per image)."""
    img = torch.where(_per_image(do_jitter), color_jitter(img, jitter, jitter_order), img)
    return torch.where(_per_image(do_blur), pil_gaussian_blur(img, sigma), img)
