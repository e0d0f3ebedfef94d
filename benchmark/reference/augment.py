"""Plain float32 augmentation of the recipe: scale / reflect-pad / crop,
colour jitter, blur, flip, CutMix, ImageNet normalisation and the resizes.

The semantics of the reference training code (PIL's BILINEAR resample with
its triangle filter, antialiased on downscale; reflect padding; torchvision's
jitter ops in a random order; PIL's GaussianBlur as three box passes per
axis; the CutMix box of ``generate_cutout_mask``; the partner of image i is
image i + 1), computed in float32 with every random quantity given as a
tensor.  Imports nothing of the program under test.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
LUMA = (0.299, 0.587, 0.114)


def normalize(img_cf):
    mean = torch.tensor(IMAGENET_MEAN, device=img_cf.device).reshape(3, 1, 1)
    std = torch.tensor(IMAGENET_STD, device=img_cf.device).reshape(3, 1, 1)
    return (img_cf - mean) / std


def nhwc(x):
    return x.permute(0, 2, 3, 1)


def nchw(x):
    return x.permute(0, 3, 1, 2)


def bilinear(x_nhwc, hw):
    """Bilinear resize (corners aligned) of an NHWC float tensor."""
    if tuple(x_nhwc.shape[1:3]) == tuple(hw):
        return x_nhwc
    return nhwc(F.interpolate(nchw(x_nhwc), size=tuple(hw), mode="bilinear",
                              align_corners=True))


def nearest(x, hw):
    """Nearest resize, source index floor(dst * in / out), over dims 1 and 2."""
    h, w = x.shape[1], x.shape[2]
    if (h, w) == tuple(hw):
        return x
    iy = torch.floor(torch.arange(hw[0], dtype=torch.float64, device=x.device) * h / hw[0])
    ix = torch.floor(torch.arange(hw[1], dtype=torch.float64, device=x.device) * w / hw[1])
    x = torch.index_select(x, 1, iy.clamp(0, h - 1).long())
    return torch.index_select(x, 2, ix.clamp(0, w - 1).long())


def _axis(u_off, out_size, in_size, valid, ratio, crop):
    """One axis of scale -> reflect pad -> crop: resample matrix [B, out, in],
    nearest source index [B, out] and the outside-the-image mask [B, out]."""
    dev = u_off.device
    v = valid.float()[:, None]
    r = torch.clamp_min(torch.floor(v * ratio[:, None]), 1.0)      # resized extent
    padded = torch.clamp_min(r, float(crop))
    off = torch.floor(u_off[:, None] * (padded - crop + 1.0))
    pos = torch.arange(out_size, dtype=torch.float32, device=dev)[None] + off
    oob = pos >= r
    period = torch.clamp_min(2.0 * (r - 1.0), 1.0)                  # reflect, no edge repeat
    m = torch.remainder(pos, period)
    rpos = torch.where(r > 1, torch.minimum(m, period - m), torch.zeros_like(m))
    scale = v / r
    support = torch.clamp_min(scale, 1.0)
    centre = (rpos + 0.5) * scale
    j = torch.arange(in_size, dtype=torch.float32, device=dev)
    t = (j[None, None, :] + 0.5 - centre[:, :, None]) / support[:, :, None]
    mat = torch.clamp_min(1.0 - torch.abs(t), 0.0)
    mat = torch.where(j[None, None, :] < v[:, :, None], mat, torch.zeros_like(mat))
    mat = mat / torch.clamp_min(mat.sum(dim=2, keepdim=True), 1e-12)
    near = torch.minimum(torch.clamp_min(torch.floor((rpos + 0.5) * scale), 0.0), v - 1.0)
    return mat, near.long(), oob


def geometric(image, labels, confs, valid_hw, crop_hw, ratio, u_y, u_x):
    """image [B, 3, H, W], labels [B, K, H, W] int, confs [B, L, H, W]."""
    ch, cw = crop_hw
    b, _, h, w = image.shape
    my, ny, oy = _axis(u_y, ch, h, valid_hw[:, 0], ratio, ch)
    mx, nx, ox = _axis(u_x, cw, w, valid_hw[:, 1], ratio, cw)
    out = torch.einsum("bpw,bcow->bcop", mx, torch.einsum("boh,bchw->bcow", my, image))
    outside = (oy[:, :, None] | ox[:, None, :])[:, None]

    def pick(maps, fill):
        k = maps.shape[1]
        maps = torch.gather(maps, 2, ny[:, None, :, None].expand(b, k, ch, w))
        maps = torch.gather(maps, 3, nx[:, None, None, :].expand(b, k, ch, cw))
        return torch.where(outside, torch.full_like(maps, fill), maps)

    return out, pick(labels, -1), pick(confs, 0.0)


def _per(v):
    return v.reshape(-1, 1, 1, 1)


def _gray(x):
    return torch.sum(x * torch.tensor(LUMA, device=x.device).reshape(1, 3, 1, 1), dim=1,
                     keepdim=True)


def _brightness(x, f):
    return torch.clamp(x * _per(f), 0.0, 1.0)


def _contrast(x, f):
    mean = _gray(x).mean(dim=(1, 2, 3), keepdim=True)
    return torch.clamp(_per(f) * x + (1.0 - _per(f)) * mean, 0.0, 1.0)


def _saturation(x, f):
    return torch.clamp(_per(f) * x + (1.0 - _per(f)) * _gray(x), 0.0, 1.0)


def _hue(x, f):
    x = torch.clamp(x, 0.0, 1.0)
    r, g, b = x.unbind(1)
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    delta = maxc - minc
    sd = torch.where(delta > 0, delta, torch.ones_like(delta))
    s = torch.where(maxc > 0, delta / torch.where(maxc > 0, maxc, torch.ones_like(maxc)),
                    torch.zeros_like(maxc))
    rc, gc, bc = (maxc - r) / sd, (maxc - g) / sd, (maxc - b) / sd
    h = torch.where(maxc == r, bc - gc, torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(delta > 0, torch.remainder(h / 6.0, 1.0), torch.zeros_like(h))
    h = torch.remainder(h + f.reshape(-1, 1, 1), 1.0)
    i = torch.floor(h * 6.0)
    fr = h * 6.0 - i
    v = maxc
    p, q, t = v * (1.0 - s), v * (1.0 - fr * s), v * (1.0 - (1.0 - fr) * s)
    sector = torch.remainder(i.long(), 6)[None]

    def pick(*vals):
        return torch.gather(torch.stack(vals), 0, sector)[0]

    return torch.stack([pick(v, q, p, p, t, v), pick(t, v, v, q, p, p),
                        pick(p, p, t, v, v, q)], dim=1)


_JITTER = (_brightness, _contrast, _saturation, _hue)


def _jitter(img, factors, order):
    for k in range(4):
        idx = _per(order[:, k])
        out = img
        for j, op in enumerate(_JITTER):
            out = torch.where(idx == j, op(img, factors[:, j]), out)
        img = out
    return img


def _box(x, a, b, dim):
    n = x.shape[dim]
    p = torch.cat([x.narrow(dim, 0, 1), x, x.narrow(dim, n - 1, 1)], dim=dim)
    return a * (p.narrow(dim, 0, n) + p.narrow(dim, 2, n)) + b * p.narrow(dim, 1, n)


def _blur(img, sigma):
    s2 = torch.clamp(torch.square(sigma), 1e-8, 2.0)
    q = s2 / (6.0 - 2.0 * s2)
    a, b = _per(q / (2.0 * q + 1.0)), _per(1.0 / (2.0 * q + 1.0))
    for _ in range(3):
        img = _box(img, a, b, 3)
    for _ in range(3):
        img = _box(img, a, b, 2)
    return img


def transform(images, labels, confs, valid_hw, crop_hw, d):
    """Geometry, then, where the draws ``d`` (a dict) carry them, jitter,
    blur and a horizontal flip."""
    img, labels, confs = geometric(images, labels, confs, valid_hw, crop_hw, d["ratio"],
                                   d["u_y"], d["u_x"])
    if d.get("do_flip") is None:
        return img, labels, confs
    img = torch.where(_per(d["do_jitter"]), _jitter(img, d["jitter"], d["jitter_order"]), img)
    img = torch.where(_per(d["do_blur"]), _blur(img, d["sigma"]), img)
    flip = d["do_flip"].reshape(-1, 1, 1, 1)
    return (torch.where(flip, img.flip(-1), img), torch.where(flip, labels.flip(-1), labels),
            torch.where(flip, confs.flip(-1), confs))


def cutmix(images, labels, confs, cut_w, u_x, u_y):
    """The box (area H W / 2, width ``cut_w``, corner from the uniforms) of
    image i taken from image i + 1 (the last from the first)."""
    h, w = images.shape[2:]
    cwf = cut_w.float()
    cut_h = torch.round(torch.full_like(cwf, h * w / 2) / cwf)
    x0 = torch.floor(u_x * (w - cwf + 1.0))
    y0 = torch.floor(u_y * (h - cut_h + 1.0))
    yy = torch.arange(h, dtype=torch.float32, device=images.device)[None, :, None]
    xx = torch.arange(w, dtype=torch.float32, device=images.device)[None, None, :]
    inside = ((yy >= y0[:, None, None]) & (yy < (y0 + cut_h)[:, None, None])
              & (xx >= x0[:, None, None]) & (xx < (x0 + cwf)[:, None, None]))
    keep = (~inside)[:, None]
    rolled = [torch.roll(t, -1, dims=0) for t in (images, labels, confs)]
    return (torch.where(keep, images, rolled[0]), torch.where(keep, labels, rolled[1]),
            torch.where(keep, confs, rolled[2]))
