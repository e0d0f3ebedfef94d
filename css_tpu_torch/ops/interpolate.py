"""Resize ops with the conventions of ``css_tpu/ops/interpolate.py``.

* ``bilinear_resize`` — ``F.interpolate(mode='bilinear')`` with either
  ``align_corners`` setting, over NHWC tensors, computed in f32 and returned
  in the input dtype;
* ``nearest_resize`` — the ``torch`` index convention,
  ``src = floor(dst * in / out)``, which is ``F.interpolate(mode='nearest')``,
  or the ``pil`` one (PIL's ``Image.NEAREST``, half-pixel centres),
  ``src = floor((dst + 0.5) * in / out)``, over HW / NHW / NHWC.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["bilinear_resize", "nearest_resize"]


def bilinear_resize(x: torch.Tensor, out_hw, align_corners: bool = True) -> torch.Tensor:
    """Bilinearly resize an NHWC tensor to ``out_hw``."""
    out_h, out_w = int(out_hw[0]), int(out_hw[1])
    if (x.shape[1], x.shape[2]) == (out_h, out_w):
        return x
    y = F.interpolate(x.permute(0, 3, 1, 2).float(), size=(out_h, out_w),
                      mode="bilinear", align_corners=align_corners)
    return y.permute(0, 2, 3, 1).to(x.dtype)


_CENTRE = {"torch": 0.0, "pil": 0.5}


def _nearest_index(in_size: int, out_size: int, convention: str, device) -> torch.Tensor:
    # float64, as the reference computes its static index table
    pos = torch.arange(out_size, dtype=torch.float64, device=device) + _CENTRE[convention]
    return torch.floor(pos * in_size / out_size).clamp(0, in_size - 1).long()


def nearest_resize(x: torch.Tensor, out_hw, convention: str = "torch") -> torch.Tensor:
    """Nearest-neighbour resize over the two spatial dims (HW, NHW or NHWC);
    ``convention`` is ``torch`` or ``pil``."""
    if convention not in _CENTRE:
        raise ValueError(f"unknown nearest convention: {convention}")
    out_h, out_w = int(out_hw[0]), int(out_hw[1])
    if x.ndim in (3, 4):
        h_ax, w_ax = 1, 2
    elif x.ndim == 2:
        h_ax, w_ax = 0, 1
    else:
        raise ValueError(f"unsupported rank {x.ndim}")
    h, w = x.shape[h_ax], x.shape[w_ax]
    if (h, w) == (out_h, out_w):
        return x
    x = torch.index_select(x, h_ax, _nearest_index(h, out_h, convention, x.device))
    return torch.index_select(x, w_ax, _nearest_index(w, out_w, convention, x.device))
