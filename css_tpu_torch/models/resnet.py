"""ResNet trunk (plain stem, output stride 8), counterpart of
``css_tpu/models/resnet.py``.

Modules take and return NCHW tensors; the parameters are f32 and are cast to
the compute dtype (``dtype``) at each conv, as Flax's ``dtype=`` does.
Parameter names follow the Flax module paths (``stem.conv.weight``,
``layer3_0.conv2.bn.running_var``, ...), so ``models/convert.py`` maps one
tree onto the other by name.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["GroupedBatchNorm", "ConvBN", "Bottleneck", "StageSpec",
           "ResNetBackbone", "resnet101", "resnet_tiny"]


def _channel(v: torch.Tensor) -> torch.Tensor:
    return v[None, :, None, None]


class GroupedBatchNorm(nn.Module):
    """BatchNorm with the reference's numerics (one group; the grouped form
    of the fused forward is not ported yet).

    Train mode: statistics in f32, variance as E[x^2] - E[x]^2; the normalize
    runs in the input dtype with f32-folded scalars; running stats move with
    momentum 0.9 and torch's unbiased n/(n-1) variance (n = B for the ASPP
    pool BN, so a factor 2 at B = 2).  Eval mode normalizes with the running
    stats, again in the input dtype.
    """

    def __init__(self, channels: int, momentum: float = 0.9, eps: float = 1e-5,
                 zero_init_scale: bool = False):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.zeros(channels) if zero_init_scale
                                   else torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = x.dtype
        if not self.training:
            inv = (self.weight * torch.rsqrt(self.running_var + self.eps)).to(dtype)
            return ((x - _channel(self.running_mean.to(dtype))) * _channel(inv)
                    + _channel(self.bias.to(dtype)))
        xf = x.float()
        mean = xf.mean(dim=(0, 2, 3))
        var = torch.square(xf).mean(dim=(0, 2, 3)) - torch.square(mean)
        inv = self.weight * torch.rsqrt(var + self.eps)
        y = ((x - _channel(mean.to(dtype))) * _channel(inv.to(dtype))
             + _channel(self.bias.to(dtype)))
        with torch.no_grad():
            n = x.numel() // x.shape[1]
            bessel = n / max(n - 1.0, 1.0)
            m = self.momentum
            self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1 - m) * var * bessel)
        return y


class ConvBN(nn.Module):
    """Conv (no bias, torch padding) + BatchNorm (+ ReLU), in ``dtype``.

    A 3x3 conv at a large dilation is a plain dilated conv here: the TPU
    side's tap-decomposed ``AtrousConv3x3`` computes the same function.
    """

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3, stride: int = 1,
                 dilation: int = 1, relu: bool = True, zero_init_scale: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stride, self.dilation, self.relu, self.dtype = stride, dilation, relu, dtype
        self.padding = dilation * (kernel - 1) // 2
        self.conv = nn.Module()
        self.conv.weight = nn.Parameter(torch.empty(out_ch, in_ch, kernel, kernel))
        # torch kaiming_normal_(mode='fan_out'), as the reference initializes
        nn.init.kaiming_normal_(self.conv.weight, mode="fan_out", nonlinearity="relu")
        self.bn = GroupedBatchNorm(out_ch, zero_init_scale=zero_init_scale)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.conv2d(x.to(self.dtype), self.conv.weight.to(self.dtype), None,
                     self.stride, self.padding, self.dilation)
        x = self.bn(x)
        if self.relu:
            x = F.relu(x)
        return x.to(self.dtype)


class Bottleneck(nn.Module):
    """torchvision bottleneck: 1x1 -> 3x3 (stride, dilation) -> 1x1 x4."""

    def __init__(self, in_ch: int, planes: int, stride: int = 1, dilation: int = 1,
                 has_downsample: bool = False, zero_init_residual: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        kw = dict(dtype=dtype)
        self.conv1 = ConvBN(in_ch, planes, 1, 1, 1, relu=True, **kw)
        self.conv2 = ConvBN(planes, planes, 3, stride, dilation, relu=True, **kw)
        self.conv3 = ConvBN(planes, planes * 4, 1, 1, 1, relu=False,
                            zero_init_scale=zero_init_residual, **kw)
        self.downsample = (ConvBN(in_ch, planes * 4, 1, stride, 1, relu=False, **kw)
                           if has_downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv3(self.conv2(self.conv1(x)))
        identity = self.downsample(x) if self.downsample is not None else x
        return F.relu(out + identity)


@dataclasses.dataclass(frozen=True)
class StageSpec:
    planes: int
    blocks: int
    stride: int
    first_dilation: int
    rest_dilation: int


class ResNetBackbone(nn.Module):
    """Plain-stem ResNet trunk returning (low-level /4 features, final features)."""

    def __init__(self, stages: Sequence[StageSpec], dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stages = tuple(stages)
        self.stem = ConvBN(3, 64, 7, 2, relu=True, dtype=dtype)
        self.block_names = []
        in_ch = 64
        for si, spec in enumerate(self.stages):
            names = []
            for bi in range(spec.blocks):
                first = bi == 0
                stride = spec.stride if first else 1
                name = f"layer{si + 1}_{bi}"
                self.add_module(name, Bottleneck(
                    in_ch, spec.planes, stride=stride,
                    dilation=spec.first_dilation if first else spec.rest_dilation,
                    has_downsample=first and (spec.stride != 1 or in_ch != spec.planes * 4),
                    dtype=dtype))
                names.append(name)
                in_ch = spec.planes * 4
            self.block_names.append(names)
        self.out_channels = in_ch
        self.low_channels = self.stages[0].planes * 4

    @property
    def output_stride(self) -> int:
        s = 4
        for spec in self.stages:
            s *= spec.stride
        return s

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self.stem(x)
        x = F.max_pool2d(x, 3, 2, 1, ceil_mode=False)
        low = None
        for si, names in enumerate(self.block_names):
            for name in names:
                x = getattr(self, name)(x)
            if si == 0:
                low = x
        return low, x


def _stage_specs(layers: Sequence[int], output_stride: int) -> Tuple[StageSpec, ...]:
    """Plain-stem stage schedule; output stride 8 reproduces the reference's
    re-dilation surgery (layer3 dilation 1 then 2, layer4 2 then 4)."""
    if output_stride != 8:
        raise ValueError(f"unsupported output_stride {output_stride} (the port has OS8)")
    l1, l2, l3, l4 = layers
    return (
        StageSpec(64, l1, 1, 1, 1),
        StageSpec(128, l2, 2, 1, 1),
        StageSpec(256, l3, 1, 1, 2),
        StageSpec(512, l4, 1, 2, 4),
    )


def resnet101(output_stride: int = 8, dtype: torch.dtype = torch.float32) -> ResNetBackbone:
    """Plain-stem ResNet-101 trunk."""
    return ResNetBackbone(_stage_specs([3, 4, 23, 3], output_stride), dtype=dtype)


def resnet_tiny(output_stride: int = 8, dtype: torch.dtype = torch.float32) -> ResNetBackbone:
    """Miniature trunk (one block per stage, narrow) for tests."""
    if output_stride != 8:
        raise ValueError("tiny trunk only supports OS8")
    return ResNetBackbone((
        StageSpec(8, 1, 1, 1, 1),
        StageSpec(16, 1, 2, 1, 1),
        StageSpec(32, 1, 1, 1, 2),
        StageSpec(64, 1, 1, 2, 4),
    ), dtype=dtype)
