"""DeepLabV3+ with the dual classifier/representation head, counterpart of
``css_tpu/models/deeplabv3.py``.

``DeepLabV3PlusDual`` takes NHWC images and returns NHWC
``(prediction [B, h/4, w/4, C], representation [B, h/4, w/4, D])`` in f32,
as the JAX model does.  Inside it runs NCHW: the NHWC input permuted to NCHW
is a channels-last tensor, which is cuDNN's fast layout, so the boundary
costs no copy.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from css_tpu_torch.models.aspp import ASPP
from css_tpu_torch.models.resnet import (ConvBN, GroupedBatchNorm, ResNetBackbone, resnet101,
                                        resnet101_stem, resnet_tiny)

__all__ = ["DeepLabV3PlusDual", "aspp_rates", "build_model", "set_distributed",
           "BACKBONES", "RESNET_BACKBONES", "MIT_BACKBONES"]

RESNET_BACKBONES = ("resnet101", "resnet101_stem", "tiny", "tiny_stem")
MIT_BACKBONES = ("mit_b5", "mit_tiny")      # SegFormer's trunks (models/segformer.py)
BACKBONES = RESNET_BACKBONES + MIT_BACKBONES


class _Head(nn.Module):
    """Conv3x3(304->256, no bias) + BN + ReLU + Conv1x1(256->out, bias)."""

    def __init__(self, in_ch: int, out_features: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.conv = ConvBN(in_ch, 256, 3, dtype=dtype)
        self.out = nn.Module()
        self.out.weight = nn.Parameter(torch.empty(out_features, 256, 1, 1))
        self.out.bias = nn.Parameter(torch.empty(out_features))
        # torch nn.Conv2d's default init
        nn.init.kaiming_uniform_(self.out.weight, a=math.sqrt(5))
        bound = 1.0 / math.sqrt(256)
        nn.init.uniform_(self.out.bias, -bound, bound)

    def forward(self, x: torch.Tensor, groups: int = 1) -> torch.Tensor:
        x = self.conv(x, groups)
        return F.conv2d(x, self.out.weight.to(self.dtype), self.out.bias.to(self.dtype))


def aspp_rates(output_stride: int):
    """The ASPP's atrous rates at ``output_stride``: (12, 24, 36) at 8,
    (6, 12, 18) at 16."""
    rates = {8: (12, 24, 36), 16: (6, 12, 18)}
    if output_stride not in rates:
        raise ValueError(f"unsupported output_stride {output_stride} (8 or 16)")
    return rates[output_stride]


class DeepLabV3PlusDual(nn.Module):
    """``output_stride`` sets the ASPP's rates and must be the trunk's own:
    a trunk of another stride raises ValueError rather than run at the
    wrong rates."""

    def __init__(self, backbone: ResNetBackbone, num_classes: int = 21,
                 output_dim: int = 256, dtype: torch.dtype = torch.float32,
                 output_stride: int = 8):
        super().__init__()
        if backbone.output_stride != output_stride:
            raise ValueError(
                f"output_stride={output_stride} does not match the backbone's stage "
                f"schedule (stride {backbone.output_stride}); pass the matching "
                f"output_stride (build_model does)")
        self.dtype = dtype
        self.backbone = backbone
        self.aspp = ASPP(backbone.out_channels, aspp_rates(output_stride), dtype=dtype)
        self.project = ConvBN(backbone.low_channels, 48, 1, dtype=dtype)
        self.classifier = _Head(48 + 256, num_classes, dtype)
        self.representation = _Head(48 + 256, output_dim, dtype)

    def output_hw(self, hw):
        """Spatial size of ``(pred, rep)`` for an input of ``hw``: about /4,
        as the trunk's stem gives it (193 at 769 under either stem; 129 at
        512 under the deep stem, 128 under the plain one)."""
        return self.backbone.low_level_hw(hw)

    def forward(self, x: torch.Tensor, bn_groups: int = 1):
        """``x`` [B, H, W, 3] -> (pred, rep), NHWC f32 at ``output_hw``.
        ``bn_groups`` > 1: the batch is that many stacked groups with
        separate BatchNorm statistics (the fused forward); it changes
        nothing in eval mode."""
        g = bn_groups
        low, feat = self.backbone(x.permute(0, 3, 1, 2), g)
        feat = self.aspp(feat, g)
        low = self.project(low, g)
        feat = F.interpolate(feat.float(), size=low.shape[2:], mode="bilinear",
                             align_corners=True).to(low.dtype)
        dec = torch.cat([low, feat], dim=1)
        pred = self.classifier(dec, g)
        rep = self.representation(dec, g)
        return (pred.float().permute(0, 2, 3, 1),
                rep.float().permute(0, 2, 3, 1))


def set_distributed(model: nn.Module, distributed: bool) -> nn.Module:
    """Turns the cross-replica statistics of every BatchNorm of ``model``
    on or off (``GroupedBatchNorm.distributed``); returns ``model``."""
    for m in model.modules():
        if isinstance(m, GroupedBatchNorm):
            m.distributed = distributed
    return model


def build_model(num_classes: int, output_dim: int = 256, backbone: str = "resnet101",
                output_stride: int = 8, dtype: torch.dtype = torch.float32,
                seed: int = 0, remat=False, remat_policy: str = "nothing",
                distributed: bool = False) -> nn.Module:
    """The student/teacher network, randomly initialized from ``seed``
    (on the CPU; move it with ``.to(device)``).  ``backbone`` is one of
    ``BACKBONES``: the plain-stem ResNet-101 (VOC), the deep-stem multi-grid
    ``resnet101_stem`` (a Cityscapes option), or the tiny test trunks, each
    under DeepLabV3+; or a MiT trunk under SegFormer's decoder
    (``models/segformer.py``: ``mit_b5``, the test trunk ``mit_tiny``).
    ``remat``/``remat_policy`` as ``ResNetBackbone`` takes them;
    ``output_stride`` 8 or 16 (the tiny trunks have 8 only).  A MiT trunk
    takes neither: it refuses ``remat`` and an ``output_stride`` other than
    the default.
    ``distributed``: every BatchNorm (trunk, ASPP, heads) takes its
    train-mode statistics over all ranks of the default process group, as
    the JAX model built with ``axis_name`` does."""
    kw = dict(dtype=dtype, remat=remat, remat_policy=remat_policy)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        if backbone in MIT_BACKBONES:
            from css_tpu_torch.models.segformer import build_segformer

            model = build_segformer(backbone, num_classes, output_dim, dtype, output_stride, remat)
            return set_distributed(model, distributed)
        if backbone == "resnet101":
            trunk = resnet101(output_stride, **kw)
        elif backbone == "resnet101_stem":
            trunk = resnet101_stem(output_stride, **kw)
        elif backbone in ("tiny", "tiny_stem"):
            trunk = resnet_tiny(output_stride, deep_stem=backbone == "tiny_stem", **kw)
        else:
            raise ValueError(f"unknown backbone {backbone} (one of {BACKBONES})")
        model = DeepLabV3PlusDual(trunk, num_classes, output_dim, dtype, output_stride)
    return set_distributed(model, distributed)
