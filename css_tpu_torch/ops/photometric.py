"""Batched photometric augmentation, counterpart of
``css_tpu/ops/photometric.py``.

Images are channel-first batches [B, 3, H, W] in [0, 1].  Every random
quantity arrives as a tensor with one entry per image: the jitter flags,
the four factors (brightness, contrast, saturation, hue), the op order (a
permutation of 0..3 per image), the blur flags and sigmas.

Two laws.  The float law (the default) jitters and blurs in f32.
``quantize=True`` is the reference's uint8 law, PIL's integer arithmetic
bit for bit: each jitter op enters and leaves on the 0..255 grid
(ImageEnhance's truncating blends, the fixed-point 'L' image, the integer
HSV round trip of the hue op), and the blur is PIL's box machinery in
integers (``_pil_gaussian_blur_q8``).  ``q8_entry_image`` and ``q8_floor``
are the reference's tensor-to-PIL entry hops, which ``ops/augment.py``
applies.  Every value on that path is an integer a float holds exactly, or
an f32 expression evaluated in the JAX package's order, so the card and the
CPU give the same pixels.  Its divisions by constants go through
``exact_div``: PyTorch's CUDA kernel multiplies by the reciprocal of a
Python-number divisor, which can land one ulp off and truncate to another
uint8 step.
"""

from __future__ import annotations

import torch

__all__ = ["color_jitter", "pil_gaussian_blur", "random_photometric", "q8_round",
           "q8_floor", "q8_entry_image", "exact_div", "device_constant"]

_LUMA = (0.299, 0.587, 0.114)
_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


_CONSTANTS = {}


def device_constant(values: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``torch.tensor(values, dtype=dtype, device=device)``, made once per
    (values, dtype, device) and kept: on the card a tensor made from host
    numbers is a copy from pageable memory that drains the stream, and a CUDA
    graph capture refuses it.  Never written to; callers take views."""
    key = (values, dtype, torch.device(device))
    t = _CONSTANTS.get(key)
    if t is None:
        with torch.inference_mode(False):
            t = _CONSTANTS[key] = torch.tensor(values, dtype=dtype, device=device)
    return t


def _per_image(v: torch.Tensor) -> torch.Tensor:
    return v.reshape(-1, 1, 1, 1)


def exact_div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` rounded once on every device: the divisor is a tensor on
    ``x``'s device (for a Python number the CUDA kernel multiplies by its
    reciprocal instead)."""
    return x / x.new_full((), c)


def q8_round(x: torch.Tensor) -> torch.Tensor:
    """[0, 1] floats snapped to the uint8 grid with PIL's round half up."""
    return exact_div(torch.floor(torch.clamp(x, 0.0, 1.0) * 255.0 + 0.5), 255.0)


def q8_floor(x: torch.Tensor) -> torch.Tensor:
    """``to_pil_image``'s float-to-uint8 hop, ``mul(255).byte()``: truncation,
    with 2^-12 of slack so that values already on k/255 keep k."""
    return exact_div(torch.floor(torch.clamp(x, 0.0, 1.0) * 255.0 + 2.0 ** -12), 255.0)


def _channel_constant(values, like: torch.Tensor) -> torch.Tensor:
    return device_constant(tuple(values), torch.float32, like.device).reshape(3, 1, 1)


def q8_entry_image(x: torch.Tensor) -> torch.Tensor:
    """The reference's image entry hop: its canvases are ImageNet-normalized
    in f32, and ``tensor_to_pil`` divides by f32(1/std), adds the mean and
    truncates ``mul(255)`` to uint8.  The f32 round trip lands a hair above
    or below k/255, so some intensities k become k - 1, by channel."""
    m = _channel_constant(_IMAGENET_MEAN, x)
    s = _channel_constant(_IMAGENET_STD, x)
    inv_s = _channel_constant([1.0 / v for v in _IMAGENET_STD], x)
    t = ((x - m) / s) / inv_s + m
    return exact_div(torch.floor(torch.clamp(t * 255.0, 0.0, 255.0)), 255.0)


def _rgb_to_grayscale(img: torch.Tensor) -> torch.Tensor:
    w = device_constant(_LUMA, img.dtype, img.device).reshape(1, 3, 1, 1)
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


def _pil_gray255(k: torch.Tensor) -> torch.Tensor:
    """PIL's RGB -> 'L' in its 16-bit fixed point, [B, 3, H, W] 0..255 ->
    [B, 1, H, W]: (19595 r + 38470 g + 7471 b + 2^15) >> 16, exact in f32
    (every partial sum stays below 2^24)."""
    r, g, b = k[:, 0:1], k[:, 1:2], k[:, 2:3]
    return torch.floor((19595.0 * r + 38470.0 * g + 7471.0 * b + 32768.0) / 65536.0)


def _pil_hue_shift255(k: torch.Tensor, hue_factor: torch.Tensor) -> torch.Tensor:
    """torchvision's PIL hue op on the 0..255 grid: PIL's rgb2hsv (hue
    ``floor(255 h6 / (6 cr))`` from the hue numerator scaled by the chroma
    cr), the hue moved by ``uint8(factor * 255)`` with wraparound, and
    colorsys' hsv2rgb with round-half-up stores.  ``hue_factor`` [B]."""
    r, g, b = k.unbind(1)
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    cr = maxc - minc
    gray = cr == 0
    h6 = torch.where(r == maxc, (maxc - b) - (maxc - g),
                     torch.where(g == maxc, 2.0 * cr + (maxc - r) - (maxc - b),
                                 4.0 * cr + (maxc - g) - (maxc - r)))
    h6 = torch.where(h6 < 0, h6 + 6.0 * cr, h6)
    crs = torch.where(gray, torch.ones_like(cr), cr)
    zero = torch.zeros_like(cr)
    hch = torch.where(gray, zero, torch.floor(h6 * 255.0 / (6.0 * crs)))
    sch = torch.where(gray, zero, torch.floor(255.0 * cr / torch.clamp_min(maxc, 1.0)))
    # np.uint8(factor * 255): truncation toward zero, then wraparound mod 256
    shift = torch.remainder(torch.trunc(hue_factor * 255.0), 256.0).reshape(-1, 1, 1)
    hch = torch.remainder(hch + shift, 256.0)

    hf = exact_div(hch, 255.0)
    i6 = torch.floor(hf * 6.0)
    f = hf * 6.0 - i6
    sf = exact_div(sch, 255.0)
    v = maxc
    p = torch.floor(v * (1.0 - sf) + 0.5)
    q = torch.floor(v * (1.0 - sf * f) + 0.5)
    t = torch.floor(v * (1.0 - sf * (1.0 - f)) + 0.5)
    sector = torch.remainder(i6.long(), 6)[None]
    pick = lambda *vals: torch.gather(torch.stack(vals), 0, sector)[0]  # noqa: E731
    return torch.stack([pick(v, q, p, p, t, v), pick(t, v, v, q, p, p),
                        pick(p, p, t, v, v, q)], dim=1)


def _q8_brightness255(k, f):
    """ImageEnhance.Brightness: a blend with black that truncates."""
    return torch.clamp(torch.floor(_per_image(f) * k), 0.0, 255.0)


def _q8_contrast255(k, f):
    """ImageEnhance.Contrast: a truncating blend with the flat gray
    ``int(mean('L') + 0.5)``, the mean rounded in integers."""
    gl = _pil_gray255(k)
    n = gl.shape[2] * gl.shape[3]
    total = gl.sum(dim=(1, 2, 3), dtype=torch.int64)
    mean = _per_image(torch.div(2 * total + n, 2 * n, rounding_mode="floor").float())
    return torch.clamp(torch.floor(mean + _per_image(f) * (k - mean)), 0.0, 255.0)


def _q8_saturation255(k, f):
    """ImageEnhance.Color: a truncating blend with the fixed-point 'L' image."""
    gl = _pil_gray255(k)
    return torch.clamp(torch.floor(gl + _per_image(f) * (k - gl)), 0.0, 255.0)


def _on_grid(op255):
    """The op on the 0..255 grid, entered with round half up from [0, 1]."""
    return lambda x, f: exact_div(op255(torch.floor(x * 255.0 + 0.5), f), 255.0)


_Q8_OPS = tuple(_on_grid(op) for op in (_q8_brightness255, _q8_contrast255,
                                        _q8_saturation255, _pil_hue_shift255))


def color_jitter(img: torch.Tensor, factors: torch.Tensor, order: torch.Tensor,
                 quantize: bool = False) -> torch.Tensor:
    """``factors`` [B, 4] (brightness, contrast, saturation, hue); ``order``
    [B, 4], each row a permutation of the four ops applied in turn;
    ``quantize``: the uint8 laws of PIL's ops."""
    ops = _Q8_OPS if quantize else (_brightness, _contrast, _saturation, _hue)
    for k in range(4):
        idx = _per_image(order[:, k])
        out = img
        for j, op in enumerate(ops):
            out = torch.where(idx == j, op(img, factors[:, j]), out)
        img = out
    return img


def _neighbours(x, dim):
    """(left, centre, right) of every entry along ``dim``, edges clamped
    (a concatenation, which every dtype has on every device)."""
    n = x.shape[dim]
    p = torch.cat([x.narrow(dim, 0, 1), x, x.narrow(dim, n - 1, 1)], dim=dim)
    return tuple(p.narrow(dim, k, n) for k in range(3))


def _box_pass(x, a, b, dim):
    lo, mid, hi = _neighbours(x, dim)
    return a * (lo + hi) + b * mid


def _pil_gaussian_blur_q8(img: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """PIL's ``ImagingGaussianBlur`` on the uint8 grid, in integers.

    Per-pass radius by PIL's extended-box formula in f32 (integer part 0 for
    sigma < sqrt(2)), weights ``ww = round(2^24 / (2r + 1))`` and
    ``fw = (2^24 - ww) // 2``, then three horizontal and three vertical
    passes, each ``clip8((c ww + (left + right) fw + 2^23) >> 24)`` with
    edge-clamped padding.  int64 holds the 2^24-scale sums that the JAX
    package splits hi/lo by 2^12; the integers are the same.  ``sigma`` [B].
    """
    sig2 = torch.clamp(exact_div(sigma * sigma, 3.0), 1e-8, 0.666)
    r = (0.0 - 3.0 * sig2) / (6.0 * (sig2 - 1.0))
    d = r * 2.0 + 1.0
    ww = torch.round(16777216.0 / d)      # half to even, as jnp.round
    fw = torch.floor((16777216.0 - ww) / 2.0)
    ww, fw = _per_image(ww.long()), _per_image(fw.long())
    k = torch.floor(img * 255.0 + 0.5).long()

    def box_pass(x, dim):
        lo, mid, hi = _neighbours(x, dim)
        return torch.clamp((mid * ww + (lo + hi) * fw + (1 << 23)) >> 24, 0, 255)

    for _ in range(3):
        k = box_pass(k, 3)   # horizontal passes first, as PIL does
    for _ in range(3):
        k = box_pass(k, 2)
    return exact_div(k.to(img.dtype), 255.0)


def pil_gaussian_blur(img: torch.Tensor, sigma: torch.Tensor,
                      quantize: bool = False) -> torch.Tensor:
    """PIL's GaussianBlur law: three fractional box passes per axis with
    per-pass radius q = sigma^2 / (6 - 2 sigma^2), edge-clamped, horizontal
    passes first.  ``sigma`` [B].  ``quantize``: PIL's integer machinery
    (:func:`_pil_gaussian_blur_q8`)."""
    if quantize:
        return _pil_gaussian_blur_q8(img, sigma)
    sig2 = torch.clamp(torch.square(sigma), 1e-8, 2.0)
    q = sig2 / (6.0 - 2.0 * sig2)
    a = _per_image(q / (2.0 * q + 1.0))
    b = _per_image(1.0 / (2.0 * q + 1.0))
    for _ in range(3):
        img = _box_pass(img, a, b, 3)
    for _ in range(3):
        img = _box_pass(img, a, b, 2)
    return img


def random_photometric(img, do_jitter, jitter, jitter_order, do_blur, sigma,
                       quantize: bool = False):
    """Jitter where ``do_jitter``, then blur where ``do_blur`` (per image)."""
    jittered = color_jitter(img, jitter, jitter_order, quantize)
    img = torch.where(_per_image(do_jitter), jittered, img)
    return torch.where(_per_image(do_blur), pil_gaussian_blur(img, sigma, quantize), img)
