"""Plain float32 SegFormer with CSS's dual head: the reference network of
``Network.name`` "SegFormer".

Xie et al., "SegFormer: Simple and Efficient Design for Semantic
Segmentation with Transformers", NeurIPS 2021, arXiv:2105.15203, as NVlabs'
code builds it (``mmseg/models/backbones/mix_transformer.py``, ``mit_b5``;
``mmseg/models/decode_heads/segformer_head.py``):

* the Mix Transformer (MiT) trunk: four stages, each an overlapping patch
  embedding (a conv with bias, 7x7 stride 4 then 3x3 stride 2, and a
  LayerNorm, eps 1e-5), pre-LN blocks (LayerNorm eps 1e-6) of efficient
  self-attention (keys and values from the tokens shrunk by an R x R
  stride-R conv + LayerNorm eps 1e-5 where R > 1; softmax(q k^T / sqrt(d)) v
  over the heads; a projection) and a Mix-FFN (Linear C -> 4C, a 3x3
  depthwise conv, exact GELU, Linear 4C -> C), and a LayerNorm (eps 1e-6);
* the all-MLP decoder: a Linear a stage to the decoder's width, bilinear
  (``align_corners=False``) to the first stage's size, concatenated
  [c4, c3, c2, c1], a 1x1 conv + BatchNorm + ReLU (``linear_fuse``), and the
  classifier ``linear_pred`` (1x1 conv with bias);
* CSS's representation head on the same fused map: 3x3 conv to 256 + BN +
  ReLU, 1x1 conv with bias.

Drop-path and the decoder's dropout are 0 (the harness draws nothing of a
network's own).  Plain PyTorch (``F.conv2d``, ``F.linear``,
``F.layer_norm``, ``F.gelu``, ``F.scaled_dot_product_attention``,
``F.batch_norm``), NCHW maps and [B, N, C] tokens, float32 throughout; it
imports nothing of the program under test.  Parameter and buffer names are
the program's, so the weight maker fills both sides with the same tensors.

``bn_groups`` > 1 splits the batch into groups that take their BatchNorm
statistics apart, first group first (the fused forward).  ``quantize`` (a
function of a tensor) is applied to both operands of every convolution and
linear layer and to the attention's query, key and value: the control of
``correct`` passes a float8 rounding there.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["SegFormer", "TRUNKS", "TINY", "build", "weight_kind"]

# widths, heads, depths, spatial-reduction ratios, decoder width; MLP ratio 4
TRUNKS = {
    "mit_b5": ((64, 128, 320, 512), (1, 2, 5, 8), (3, 6, 40, 3), (8, 4, 2, 1), 768),
    "mit_tiny": ((8, 16, 24, 32), (1, 2, 3, 4), (1, 1, 2, 1), (8, 4, 2, 1), 32),
}
MLP_RATIO = 4
BN_MOMENTUM = 0.1      # new = 0.9 old + 0.1 batch
BN_EPS = 1e-5
TINY = {"backbone": "mit_tiny"}     # the Network group's overrides at the tests' size


def _identity(x):
    return x


def _param(*shape):
    return nn.Parameter(torch.empty(*shape))


class _Linear(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.weight, self.bias = _param(cout, cin), _param(cout)

    def forward(self, x, q):
        return F.linear(q(x), q(self.weight), self.bias)


class _Conv(nn.Module):
    def __init__(self, cin, cout, k, stride=1, padding=None, groups=1, bias=True):
        super().__init__()
        self.weight = _param(cout, cin // groups, k, k)
        if bias:
            self.bias = _param(cout)
        self.stride, self.groups = stride, groups
        self.padding = k // 2 if padding is None else padding

    def forward(self, x, q):
        return F.conv2d(q(x), q(self.weight), getattr(self, "bias", None), self.stride,
                        self.padding, 1, self.groups)


class _LN(nn.Module):
    def __init__(self, ch, eps):
        super().__init__()
        self.weight, self.bias, self.eps = _param(ch), _param(ch), eps

    def forward(self, x):
        return F.layer_norm(x, x.shape[-1:], self.weight, self.bias, self.eps)


class _BN(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.weight, self.bias = _param(ch), _param(ch)
        self.register_buffer("running_mean", torch.empty(ch))
        self.register_buffer("running_var", torch.empty(ch))

    def forward(self, x, groups: int):
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                                False, 0.0, BN_EPS)
        parts = [F.batch_norm(part, self.running_mean, self.running_var, self.weight,
                              self.bias, True, BN_MOMENTUM, BN_EPS)
                 for part in x.chunk(groups, dim=0)]
        return torch.cat(parts, dim=0) if groups > 1 else parts[0]


class ConvBN(nn.Module):
    """Conv without bias + BN + ReLU; names ``conv.weight``, ``bn.*``."""

    def __init__(self, cin, cout, k):
        super().__init__()
        self.conv = _Conv(cin, cout, k, bias=False)
        self.bn = _BN(cout)

    def forward(self, x, groups, q):
        return F.relu(self.bn(self.conv(x, q), groups))


def _tokens(x):
    """[B, C, h, w] -> [B, h*w, C]."""
    return x.flatten(2).transpose(1, 2)


def _map(t, hw):
    """[B, h*w, C] -> [B, C, h, w]."""
    return t.transpose(1, 2).reshape(t.shape[0], t.shape[2], *hw)


class PatchEmbed(nn.Module):
    def __init__(self, cin, width, k, stride):
        super().__init__()
        self.proj = _Conv(cin, width, k, stride)
        self.norm = _LN(width, 1e-5)

    def forward(self, x, q):
        x = self.proj(x, q)
        return self.norm(_tokens(x)), tuple(x.shape[2:])


class Attention(nn.Module):
    def __init__(self, width, heads, sr_ratio):
        super().__init__()
        self.heads, self.sr_ratio = heads, sr_ratio
        self.q = _Linear(width, width)
        self.kv = _Linear(width, 2 * width)
        self.proj = _Linear(width, width)
        if sr_ratio > 1:
            self.sr = _Conv(width, width, sr_ratio, sr_ratio, padding=0)
            self.norm = _LN(width, 1e-5)

    def forward(self, x, hw, q):
        b, n, c = x.shape
        h, d = self.heads, c // self.heads
        qh = self.q(x, q).reshape(b, n, h, d).transpose(1, 2)
        y = self.norm(_tokens(self.sr(_map(x, hw), q))) if self.sr_ratio > 1 else x
        kv = self.kv(y, q).reshape(b, -1, 2, h, d).permute(2, 0, 3, 1, 4)
        o = F.scaled_dot_product_attention(q(qh), q(kv[0]), q(kv[1]))    # scale 1/sqrt(d)
        return self.proj(o.transpose(1, 2).reshape(b, n, c), q)


class DWConv(nn.Module):
    def __init__(self, width):
        super().__init__()
        self.dwconv = _Conv(width, width, 3, groups=width)


class MixFFN(nn.Module):
    def __init__(self, width, hidden):
        super().__init__()
        self.fc1 = _Linear(width, hidden)
        self.dwconv = DWConv(hidden)
        self.fc2 = _Linear(hidden, width)

    def forward(self, x, hw, q):
        y = self.dwconv.dwconv(_map(self.fc1(x, q), hw), q)
        return self.fc2(_tokens(F.gelu(y)), q)


class Block(nn.Module):
    def __init__(self, width, heads, sr_ratio):
        super().__init__()
        self.norm1 = _LN(width, 1e-6)
        self.attn = Attention(width, heads, sr_ratio)
        self.norm2 = _LN(width, 1e-6)
        self.mlp = MixFFN(width, width * MLP_RATIO)

    def forward(self, x, hw, q):
        x = x + self.attn(self.norm1(x), hw, q)
        return x + self.mlp(self.norm2(x), hw, q)


class MiT(nn.Module):
    def __init__(self, widths, heads, depths, sr_ratios):
        super().__init__()
        self.stages = len(widths)
        cin = 3
        for i, w in enumerate(widths, 1):
            self.add_module(f"patch_embed{i}", PatchEmbed(cin, w, 7 if i == 1 else 3,
                                                          4 if i == 1 else 2))
            self.add_module(f"block{i}", nn.ModuleList(
                Block(w, heads[i - 1], sr_ratios[i - 1]) for _ in range(depths[i - 1])))
            self.add_module(f"norm{i}", _LN(w, 1e-6))
            cin = w

    def forward(self, x, q):
        outs = []
        for i in range(1, self.stages + 1):
            t, hw = getattr(self, f"patch_embed{i}")(x, q)
            for block in getattr(self, f"block{i}"):
                t = block(t, hw, q)
            x = _map(getattr(self, f"norm{i}")(t), hw)
            outs.append(x)
        return outs


class _MLP(nn.Module):
    def __init__(self, cin, width):
        super().__init__()
        self.proj = _Linear(cin, width)


class DecodeHead(nn.Module):
    def __init__(self, widths, width, num_classes):
        super().__init__()
        for i, c in enumerate(widths, 1):
            self.add_module(f"linear_c{i}", _MLP(c, width))
        self.linear_fuse = ConvBN(len(widths) * width, width, 1)
        self.linear_pred = _Conv(width, num_classes, 1)


class Head(nn.Module):
    """CSS's representation head: 3x3 conv to 256 + BN + ReLU, 1x1 conv."""

    def __init__(self, cin, cout):
        super().__init__()
        self.conv = ConvBN(cin, 256, 3)
        self.out = _Conv(256, cout, 1)

    def forward(self, x, groups, q):
        return self.out(self.conv(x, groups, q), q)


class SegFormer(nn.Module):
    """``forward(x NHWC) -> (pred, rep)``, NHWC, at the first stage's size."""

    def __init__(self, trunk: str, num_classes: int, output_dim: int = 256):
        super().__init__()
        if trunk not in TRUNKS:
            raise ValueError(f"reference: no trunk {trunk!r} (one of {sorted(TRUNKS)})")
        widths, heads, depths, sr_ratios, width = TRUNKS[trunk]
        self.backbone = MiT(widths, heads, depths, sr_ratios)
        self.decode_head = DecodeHead(widths, width, num_classes)
        self.representation = Head(width, output_dim)
        self.quantize = _identity

    def forward(self, x, bn_groups: int = 1):
        q, g, head = self.quantize, bn_groups, self.decode_head
        feats = self.backbone(x.permute(0, 3, 1, 2), q)
        size = feats[0].shape[2:]
        maps = []
        for i, f in enumerate(feats, 1):
            y = _map(getattr(head, f"linear_c{i}").proj(_tokens(f), q), f.shape[2:])
            if y.shape[2:] != size:
                y = F.interpolate(y, size=size, mode="bilinear", align_corners=False)
            maps.append(y)
        fused = head.linear_fuse(torch.cat(maps[::-1], dim=1), g, q)
        pred = head.linear_pred(fused, q)
        rep = self.representation(fused, g, q)
        return pred.permute(0, 2, 3, 1), rep.permute(0, 2, 3, 1)


def build(network: dict) -> SegFormer:
    """The network of a configuration's ``Network`` group, its tensors
    uninitialised: the weight maker fills them."""
    if network.get("output_stride", 8) != 8 or network.get("remat", False):
        raise ValueError("reference: a MiT trunk has no output stride or remat to set")
    return SegFormer(network["backbone"], network["num_class"], network.get("output_dim", 256))


def weight_kind(name: str, t: torch.Tensor):
    """The initial value of each tensor, by SegFormer's ``_init_weights``
    and mmseg's decode heads: Linear weights truncated normal with std 0.02
    (the decoder's four too); LayerNorm scales 1 and shifts 0; convolutions
    normal with He's fan-out variance over their groups; every bias of
    those 0; the classifier ``linear_pred`` normal with std 0.01, bias 0;
    the fuse's and the representation head's BatchNorms scales 1, shifts 0,
    running means 0 and variances 1; the representation head's convolutions
    as in ``DeepLabv3Plus.py`` (He fan-out, its last 1x1 and bias uniform in
    +-1/sqrt(fan in))."""
    if name.endswith("running_var"):
        return "one"
    if name.endswith("running_mean"):
        return "zero"
    if name.startswith("representation.out."):
        return "uniform"
    if name.startswith("decode_head.linear_pred."):
        return ("trunc_normal", 0.01) if name.endswith("weight") else "zero"
    if name.endswith("bias"):
        return "zero"
    if t.dim() == 1:                                     # LayerNorm and BN scales
        return "one"
    if t.dim() == 2:
        return ("trunc_normal", 0.02)
    if t.dim() == 4:
        groups = t.shape[0] if name.endswith("dwconv.dwconv.weight") else 1
        return ("he_fan_out", groups) if groups > 1 else "he_fan_out"
    raise ValueError(f"weights: no rule for {name} {tuple(t.shape)}")
