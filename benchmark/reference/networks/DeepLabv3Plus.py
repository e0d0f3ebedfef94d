"""Plain float32 DeepLabV3+ with the dual classifier / representation head:
the reference network of ``Network.name`` "DeepLabv3Plus".

The network of the recipe as published (DeepLabV3+, ResNet-101 trunk with
the plain 7x7 stem, output stride 8 by dilation, ASPP rates 12/24/36, a
48-channel low-level projection, two 3x3 + 1x1 heads), in plain PyTorch:
``F.conv2d``, ``F.batch_norm`` and ``F.relu``, NCHW, float32 throughout.
It imports nothing of the program under test.

Parameter and buffer names are the program's, so the benchmark's weight
maker (``benchmark/weights.py``) fills both sides with the same tensors, by
the rules of ``weight_kind``.

``bn_groups`` > 1 splits the batch into that many equal groups that take
their BatchNorm statistics apart, the running statistics advanced group by
group, first group first (the fused labeled + unlabeled forward).

``quantize`` (a function of a tensor) is applied to both operands of every
convolution; the control of ``correct`` passes a float8 rounding there.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["DeepLab", "TRUNKS", "TINY", "build", "weight_kind"]

# (planes, blocks, stride, first dilation, other dilations) per stage, output stride 8
TRUNKS = {
    "resnet101": ((64, 3, 1, 1, 1), (128, 4, 2, 1, 1), (256, 23, 1, 1, 2), (512, 3, 1, 2, 4)),
    "tiny": ((8, 1, 1, 1, 1), (16, 1, 2, 1, 1), (32, 1, 1, 1, 2), (64, 1, 1, 2, 4)),
}
ASPP_RATES = (12, 24, 36)
BN_MOMENTUM = 0.1      # new = 0.9 old + 0.1 batch
BN_EPS = 1e-5
TINY = {"backbone": "tiny"}     # the Network group's overrides at the tests' size


def _identity(x):
    return x


class _Weight(nn.Module):
    def __init__(self, *shape):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(*shape))


class _BN(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))
        self.register_buffer("running_mean", torch.zeros(ch))
        self.register_buffer("running_var", torch.ones(ch))

    def forward(self, x, groups: int):
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                                False, 0.0, BN_EPS)
        parts = [F.batch_norm(part, self.running_mean, self.running_var, self.weight,
                              self.bias, True, BN_MOMENTUM, BN_EPS)
                 for part in x.chunk(groups, dim=0)]
        return torch.cat(parts, dim=0) if groups > 1 else parts[0]


class ConvBN(nn.Module):
    def __init__(self, cin, cout, k, stride=1, dilation=1, relu=True):
        super().__init__()
        self.conv = _Weight(cout, cin, k, k)
        self.bn = _BN(cout)
        self.stride, self.dilation, self.relu = stride, dilation, relu
        self.padding = dilation * (k - 1) // 2

    def forward(self, x, groups, q):
        x = F.conv2d(q(x), q(self.conv.weight), None, self.stride, self.padding, self.dilation)
        x = self.bn(x, groups)
        return F.relu(x) if self.relu else x


class Bottleneck(nn.Module):
    def __init__(self, cin, planes, stride, dilation, downsample):
        super().__init__()
        self.conv1 = ConvBN(cin, planes, 1)
        self.conv2 = ConvBN(planes, planes, 3, stride, dilation)
        self.conv3 = ConvBN(planes, planes * 4, 1, relu=False)
        self.downsample = ConvBN(cin, planes * 4, 1, stride, relu=False) if downsample else None

    def forward(self, x, groups, q):
        out = self.conv3(self.conv2(self.conv1(x, groups, q), groups, q), groups, q)
        skip = x if self.downsample is None else self.downsample(x, groups, q)
        return F.relu(out + skip)


class Backbone(nn.Module):
    def __init__(self, stages):
        super().__init__()
        self.stem = ConvBN(3, 64, 7, 2)
        cin, self.names = 64, []
        for si, (planes, blocks, stride, d_first, d_rest) in enumerate(stages):
            for bi in range(blocks):
                name = f"layer{si + 1}_{bi}"
                first = bi == 0
                self.add_module(name, Bottleneck(
                    cin, planes, stride if first else 1, d_first if first else d_rest,
                    first and (stride != 1 or cin != planes * 4)))
                self.names.append((si, name))
                cin = planes * 4
        self.out_channels, self.low_channels = cin, stages[0][0] * 4

    def forward(self, x, groups, q):
        x = F.max_pool2d(self.stem(x, groups, q), 3, 2, 1)
        low = None
        for si, name in self.names:
            x = getattr(self, name)(x, groups, q)
            if si == 0:
                low = x
        return low, x


class ASPP(nn.Module):
    def __init__(self, cin, rates=ASPP_RATES, features=256):
        super().__init__()
        self.conv1x1 = ConvBN(cin, features, 1)
        for i, r in enumerate(rates):
            self.add_module(f"atrous{i}", ConvBN(cin, features, 3, 1, r))
        self.rates = rates
        self.pool_conv = ConvBN(cin, features, 1)
        self.project = ConvBN(features * (2 + len(rates)), features, 1)

    def forward(self, x, groups, q):
        branches = [self.conv1x1(x, groups, q)]
        branches += [getattr(self, f"atrous{i}")(x, groups, q) for i in range(len(self.rates))]
        pooled = self.pool_conv(x.mean(dim=(2, 3), keepdim=True), groups, q)
        branches.append(pooled.expand_as(branches[0]))
        return self.project(torch.cat(branches, dim=1), groups, q)


class Head(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv = ConvBN(cin, 256, 3)
        self.out = _Weight(cout, 256, 1, 1)
        self.out.bias = nn.Parameter(torch.empty(cout))

    def forward(self, x, groups, q):
        return F.conv2d(q(self.conv(x, groups, q)), q(self.out.weight), self.out.bias)


class DeepLab(nn.Module):
    """``forward(x NHWC) -> (pred, rep)``, NHWC, at about a quarter of the
    input's size."""

    def __init__(self, trunk: str, num_classes: int, output_dim: int = 256):
        super().__init__()
        if trunk not in TRUNKS:
            raise ValueError(f"reference: no trunk {trunk!r} (one of {sorted(TRUNKS)})")
        self.backbone = Backbone(TRUNKS[trunk])
        self.aspp = ASPP(self.backbone.out_channels)
        self.project = ConvBN(self.backbone.low_channels, 48, 1)
        self.classifier = Head(48 + 256, num_classes)
        self.representation = Head(48 + 256, output_dim)
        self.quantize = _identity

    def forward(self, x, bn_groups: int = 1):
        q, g = self.quantize, bn_groups
        low, feat = self.backbone(x.permute(0, 3, 1, 2), g, q)
        feat = self.aspp(feat, g, q)
        low = self.project(low, g, q)
        feat = F.interpolate(feat, size=low.shape[2:], mode="bilinear", align_corners=True)
        dec = torch.cat([low, feat], dim=1)
        pred = self.classifier(dec, g, q)
        rep = self.representation(dec, g, q)
        return pred.permute(0, 2, 3, 1), rep.permute(0, 2, 3, 1)


def build(network: dict) -> DeepLab:
    """The network of a configuration's ``Network`` group, its tensors
    uninitialised: the weight maker fills them."""
    if network.get("output_stride", 8) != 8:
        raise ValueError("reference: output stride 8 only")
    return DeepLab(network["backbone"], network["num_class"], network.get("output_dim", 256))


def weight_kind(name: str, t: torch.Tensor):
    """The initial value of each tensor: convolutions normal with He's
    fan-out variance (torchvision's ResNet initialisation, which the recipe
    uses for every layer it does not load); the heads' final 1x1
    convolutions and their biases uniform in +-1/sqrt(fan in) (PyTorch's
    default for a convolution); BatchNorm scales 1 and shifts 0, running
    means 0 and variances 1."""
    if name.endswith("bn.weight") or name.endswith("running_var"):
        return "one"
    if name.endswith("bn.bias") or name.endswith("running_mean"):
        return "zero"
    if name.endswith("out.weight") or name.endswith("out.bias"):
        return "uniform"
    if name.endswith("conv.weight") and t.dim() == 4:
        return "he_fan_out"
    raise ValueError(f"weights: no rule for {name} {tuple(t.shape)}")
