"""SegFormer (Xie et al., NeurIPS 2021, arXiv:2105.15203) with CSS's dual
head: the Mix Transformer trunk (MiT), the all-MLP decoder, its classifier
``linear_pred`` and the CSS representation head beside it.

``SegFormerDual`` keeps ``DeepLabV3PlusDual``'s interface: NHWC images in,
NHWC f32 ``(prediction, representation)`` out at a quarter of the input's
size (the first patch embedding's), ``bn_groups`` for the fused forward.
It has no counterpart in ``css_tpu``; ``benchmark/reference/networks/
SegFormer.py`` is its float32 reference.

Layout and precision.  Tokens are [B, h*w, C], which is the NHWC map
flattened, so a channels-last NCHW view of them (``_map``) feeds the patch
embeddings, the spatial-reduction convolution and the depthwise convolution
without a copy, and their channels-last outputs flatten back as views
(``_tokens``).  Matrix products and convolutions run in ``dtype`` (the
weights cast at each call, as ``ConvBN`` does); the residual stream is
f32, every LayerNorm normalises in f32 and rounds its output once to
``dtype``; BatchNorm (the decoder's fuse and the representation head, the
only BNs) takes f32 statistics through ``ConvBN``.  Attention is
``F.scaled_dot_product_attention``; on a CUDA tensor only the fused
kernels may run it (flash, else memory-efficient), and it raises rather
than take the math path.

Parameter names are those of NVlabs' ``mit_b5`` under ``backbone.`` and of
its ``SegFormerHead`` under ``decode_head.``; the representation head is
``representation.*``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from css_tpu_torch.models.deeplabv3 import _Head
from css_tpu_torch.models.resnet import ConvBN
from css_tpu_torch.utils.profiling import span

__all__ = ["MiTSpec", "MIT_SPECS", "MLP_RATIO", "MixVisionTransformer", "SegFormerDual",
           "build_segformer"]


@dataclasses.dataclass(frozen=True)
class MiTSpec:
    widths: Tuple[int, ...]
    heads: Tuple[int, ...]
    depths: Tuple[int, ...]
    sr_ratios: Tuple[int, ...]
    decoder_width: int


MLP_RATIO = 4
MIT_SPECS = {
    # NVlabs/SegFormer mix_transformer.py ``mit_b5``; segformer.b5 configs' decoder 768
    "mit_b5": MiTSpec((64, 128, 320, 512), (1, 2, 5, 8), (3, 6, 40, 3), (8, 4, 2, 1), 768),
    # the CPU tests' trunk: the same pattern, narrow and shallow
    "mit_tiny": MiTSpec((8, 16, 24, 32), (1, 2, 3, 4), (1, 1, 2, 1), (8, 4, 2, 1), 32),
}


def _tokens(x: torch.Tensor) -> torch.Tensor:
    """[B, C, h, w] (channels-last memory) -> [B, h*w, C], a view."""
    return x.permute(0, 2, 3, 1).flatten(1, 2)


def _map(t: torch.Tensor, hw) -> torch.Tensor:
    """[B, h*w, C] -> [B, C, h, w], a channels-last view."""
    b, _, c = t.shape
    return t.reshape(b, hw[0], hw[1], c).permute(0, 3, 1, 2)


def _linear(x: torch.Tensor, m: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    return F.linear(x.to(dtype), m.weight.to(dtype), m.bias.to(dtype))


def _conv(x: torch.Tensor, m: nn.Conv2d, dtype: torch.dtype) -> torch.Tensor:
    return F.conv2d(x.to(dtype), m.weight.to(dtype), m.bias.to(dtype), m.stride, m.padding,
                    m.dilation, m.groups)


def _layer_norm(x: torch.Tensor, m: nn.LayerNorm, dtype: torch.dtype) -> torch.Tensor:
    """LayerNorm in f32 (statistics and affine), the output rounded once."""
    return F.layer_norm(x.float(), m.normalized_shape, m.weight, m.bias, m.eps).to(dtype)


def _attention(q, k, v):
    if not q.is_cuda:
        return F.scaled_dot_product_attention(q, k, v)
    from torch.nn.attention import SDPBackend, sdpa_kernel

    with sdpa_kernel([SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION]):
        return F.scaled_dot_product_attention(q, k, v)


def _init_(module: nn.Module) -> None:
    """SegFormer's ``_init_weights``: Linear truncated normal (std 0.02),
    LayerNorm one and zero, convolutions normal with He's fan-out variance
    (over groups), biases zero."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            nn.init.trunc_normal_(m.weight, std=0.02)
            nn.init.zeros_(m.bias)
        elif isinstance(m, nn.LayerNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
        elif isinstance(m, nn.Conv2d):
            fan_out = m.kernel_size[0] * m.kernel_size[1] * m.out_channels // m.groups
            nn.init.normal_(m.weight, 0.0, math.sqrt(2.0 / fan_out))
            if m.bias is not None:
                nn.init.zeros_(m.bias)


class OverlapPatchEmbed(nn.Module):
    """Conv (7x7 stride 4 pad 3 first, then 3x3 stride 2 pad 1) + LayerNorm."""

    def __init__(self, in_ch: int, width: int, kernel: int, stride: int):
        super().__init__()
        self.proj = nn.Conv2d(in_ch, width, kernel, stride, kernel // 2)
        self.norm = nn.LayerNorm(width, eps=1e-5)

    def forward(self, x: torch.Tensor, dtype: torch.dtype):
        x = _conv(x, self.proj, dtype)
        return _layer_norm(_tokens(x), self.norm, torch.float32), tuple(x.shape[2:])


class Attention(nn.Module):
    """Efficient self-attention: keys and values from the tokens shrunk by
    an R x R stride-R conv + LayerNorm (R > 1)."""

    def __init__(self, width: int, heads: int, sr_ratio: int):
        super().__init__()
        self.heads, self.sr_ratio = heads, sr_ratio
        self.q = nn.Linear(width, width)
        self.kv = nn.Linear(width, 2 * width)
        self.proj = nn.Linear(width, width)
        if sr_ratio > 1:
            self.sr = nn.Conv2d(width, width, sr_ratio, sr_ratio)
            self.norm = nn.LayerNorm(width, eps=1e-5)

    def forward(self, x: torch.Tensor, hw, dtype: torch.dtype) -> torch.Tensor:
        b, n, c = x.shape
        h, d = self.heads, c // self.heads
        q = _linear(x, self.q, dtype).view(b, n, h, d).transpose(1, 2)
        y = x
        if self.sr_ratio > 1:
            y = _layer_norm(_tokens(_conv(_map(x, hw), self.sr, dtype)), self.norm, dtype)
        kv = _linear(y, self.kv, dtype)
        k, v = kv.view(b, -1, 2, h, d).permute(2, 0, 3, 1, 4)
        o = _attention(q, k, v)                                    # [B, h, N, d]
        return _linear(o.transpose(1, 2).reshape(b, n, c), self.proj, dtype)


class DWConv(nn.Module):
    """The depthwise 3x3 conv's holder, for NVlabs' name ``mlp.dwconv.dwconv``."""

    def __init__(self, width: int):
        super().__init__()
        self.dwconv = nn.Conv2d(width, width, 3, 1, 1, groups=width)


class MixFFN(nn.Module):
    """Linear(C, 4C), depthwise 3x3 conv on the map, exact GELU, Linear(4C, C)."""

    def __init__(self, width: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(width, hidden)
        self.dwconv = DWConv(hidden)
        self.fc2 = nn.Linear(hidden, width)

    def forward(self, x: torch.Tensor, hw, dtype: torch.dtype) -> torch.Tensor:
        y = _conv(_map(_linear(x, self.fc1, dtype), hw), self.dwconv.dwconv, dtype)
        return _linear(_tokens(F.gelu(y)), self.fc2, dtype)


class Block(nn.Module):
    """``x + Attn(LN1(x))``, then ``x + MixFFN(LN2(x))``; ``x`` f32."""

    def __init__(self, width: int, heads: int, sr_ratio: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(width, eps=1e-6)
        self.attn = Attention(width, heads, sr_ratio)
        self.norm2 = nn.LayerNorm(width, eps=1e-6)
        self.mlp = MixFFN(width, width * MLP_RATIO)

    def forward(self, x: torch.Tensor, hw, dtype: torch.dtype) -> torch.Tensor:
        x = x + self.attn(_layer_norm(x, self.norm1, dtype), hw, dtype)
        return x + self.mlp(_layer_norm(x, self.norm2, dtype), hw, dtype)


class MixVisionTransformer(nn.Module):
    """The MiT trunk: four stages of a patch embedding, blocks and a
    LayerNorm (eps 1e-6).  ``forward(x NCHW)`` -> [(tokens [B, h*w, C] in
    ``dtype``, (h, w))] of the four stages, at strides 4, 8, 16, 32."""

    def __init__(self, spec: MiTSpec, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.spec, self.dtype = spec, dtype
        in_ch = 3
        for i, width in enumerate(spec.widths, 1):
            first = i == 1
            self.add_module(f"patch_embed{i}", OverlapPatchEmbed(in_ch, width, 7 if first else 3,
                                                                 4 if first else 2))
            self.add_module(f"block{i}", nn.ModuleList(
                Block(width, spec.heads[i - 1], spec.sr_ratios[i - 1])
                for _ in range(spec.depths[i - 1])))
            self.add_module(f"norm{i}", nn.LayerNorm(width, eps=1e-6))
            in_ch = width

    def forward(self, x: torch.Tensor) -> List[Tuple[torch.Tensor, Tuple[int, int]]]:
        outs = []
        for i in range(1, len(self.spec.widths) + 1):
            t, hw = getattr(self, f"patch_embed{i}")(x, self.dtype)
            for block in getattr(self, f"block{i}"):
                t = block(t, hw, self.dtype)
            t = _layer_norm(t, getattr(self, f"norm{i}"), self.dtype)
            outs.append((t, hw))
            x = _map(t, hw)
        return outs


class _MLP(nn.Module):
    """NVlabs' ``MLP`` of the decoder: holds ``proj``."""

    def __init__(self, in_ch: int, width: int):
        super().__init__()
        self.proj = nn.Linear(in_ch, width)


class SegFormerHead(nn.Module):
    """The all-MLP decoder: a Linear a stage, bilinear (``align_corners``
    False, in f32) to the first stage's size, concatenated [c4, c3, c2, c1],
    the fuse (1x1 conv, BN, ReLU) and the classifier ``linear_pred``."""

    def __init__(self, widths, width: int, num_classes: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        for i, c in enumerate(widths, 1):
            self.add_module(f"linear_c{i}", _MLP(c, width))
        self.linear_fuse = ConvBN(len(widths) * width, width, 1, dtype=dtype)
        self.linear_pred = nn.Conv2d(width, num_classes, 1)

    def forward(self, feats, groups: int = 1):
        """``feats`` as the trunk returns them -> (prediction, fused map),
        NCHW in ``dtype``."""
        dt, size = self.dtype, feats[0][1]
        maps = []
        for i, (t, hw) in enumerate(feats, 1):
            y = _map(_linear(t, getattr(self, f"linear_c{i}").proj, dt), hw)
            if hw != size:
                y = F.interpolate(y.float(), size=size, mode="bilinear",
                                  align_corners=False).to(dt)
            maps.append(y)
        fused = self.linear_fuse(torch.cat(maps[::-1], dim=1), groups)
        return _conv(fused, self.linear_pred, dt), fused


class SegFormerDual(nn.Module):
    """``forward(x [B, H, W, 3], bn_groups=1)`` -> (pred, rep), NHWC f32 at
    ``output_hw``; ``bn_groups`` > 1 splits the batch into groups with their
    own BatchNorm statistics (the fused forward)."""

    def __init__(self, spec: MiTSpec, num_classes: int = 21, output_dim: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.backbone = MixVisionTransformer(spec, dtype)
        self.decode_head = SegFormerHead(spec.widths, spec.decoder_width, num_classes, dtype)
        _init_(self)
        # mmseg's classifier rule (normal, std 0.01), bias zero
        nn.init.trunc_normal_(self.decode_head.linear_pred.weight, std=0.01)
        self.representation = _Head(spec.decoder_width, output_dim, dtype)

    @staticmethod
    def output_hw(hw):
        """The first patch embedding's size: (h - 1) // 4 + 1 (128 at 512)."""
        return (hw[0] - 1) // 4 + 1, (hw[1] - 1) // 4 + 1

    def forward(self, x: torch.Tensor, bn_groups: int = 1):
        with span("css.encoder"):
            feats = self.backbone(x.permute(0, 3, 1, 2))
        with span("css.decoder"):
            pred, fused = self.decode_head(feats, bn_groups)
            rep = self.representation(fused, bn_groups)
            return (pred.float().permute(0, 2, 3, 1),
                    rep.float().permute(0, 2, 3, 1))


def build_segformer(backbone: str, num_classes: int, output_dim: int = 256,
                    dtype: torch.dtype = torch.float32, output_stride: int = 8,
                    remat=False) -> SegFormerDual:
    """SegFormer with a MiT trunk of ``MIT_SPECS``.  It has no output stride
    to choose and no remat: ``output_stride`` other than the default and a
    true ``remat`` raise ValueError."""
    if output_stride != 8:
        raise ValueError(f"output_stride={output_stride}: a MiT trunk ({backbone}) has no "
                         f"output stride to set")
    if remat:
        raise ValueError(f"remat={remat!r}: a MiT trunk ({backbone}) has no remat")
    return SegFormerDual(MIT_SPECS[backbone], num_classes, output_dim, dtype)
