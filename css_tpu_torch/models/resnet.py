"""ResNet trunks (plain or deep stem, output stride 8 or 16), counterpart of
``css_tpu/models/resnet.py``.

Modules take and return NCHW tensors; the parameters are f32 and are cast to
the compute dtype (``dtype``) at each conv, as Flax's ``dtype=`` does.
Parameter names follow the Flax module paths (``stem.conv.weight``,
``layer3_0.conv2.bn.running_var``, ``stem1.bn.weight``, ``layer6_0...``), so
``models/convert.py`` maps one tree onto the other by name.

Every ``forward`` takes ``groups``: the batch is that many equal groups that
keep separate BatchNorm statistics (the fused labeled + unlabeled forward).

``remat`` recomputes the bottlenecks of the chosen stages in backward
(``torch.utils.checkpoint``).  The recompute leaves the BatchNorm running
stats alone: each BN advances them once per forward, as without remat.  A
cross-replica BN's recompute issues its all-reduce again; every rank
recomputes the same blocks in the same order, so the collectives pair up.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from css_tpu_torch.ops.kernels import batchnorm_kernels as bn_kernels
from css_tpu_torch.parallel.mesh import all_reduce_sum

__all__ = ["GroupedBatchNorm", "ConvBN", "Bottleneck", "StageSpec", "ResNetBackbone",
           "REMAT_POLICIES", "resnet101", "resnet101_stem", "resnet_tiny"]

REMAT_POLICIES = ("nothing", "save_mid")


def _channel(v: torch.Tensor) -> torch.Tensor:
    return v[None, :, None, None]


class GroupedBatchNorm(nn.Module):
    """BatchNorm with the reference's numerics, statistics per batch group.

    Train mode: the leading axis splits into ``groups`` equal groups; each
    takes its statistics in f32 (variance as E[x^2] - E[x]^2).  The running
    stats then move with momentum 0.9 once per group, group 0 first, each
    time with torch's unbiased n/(n-1) variance, n = (B/G)·H·W (B/G for the
    ASPP pool BN).  ``update_stats`` False (while a checkpointed block is
    recomputed) leaves the running stats as they are.  Eval mode normalizes
    with the running stats in the input dtype.

    On a CUDA tensor train mode runs :meth:`fused_train`: the
    ``batchnorm_kernels`` normalize in f32 with the add and the ReLU that
    follow, and round the output once to the input dtype.  Elsewhere
    :meth:`_normalize` normalizes in the input dtype with f32-folded scalars
    and the add and the ReLU follow in that dtype, as the reference does.

    ``distributed`` True (``build_model(distributed=True)``): the statistics
    count every replica, as the JAX module's ``axis_name`` does: n counts
    every replica's rows, and the sums go through ``all_reduce_sum`` over
    the default process group.  On the card the fused path reduces the
    stacked [2, G, C] f32 sums of x and x^2 in the forward and those of the
    gradient in the backward, one all-reduce each; elsewhere the module
    reduces each group's f32 mean and E[x^2] through one differentiable
    all-reduce and divides by the world size.  The module holds a flag, not
    a process group, so a deep copy (the teacher) keeps it.
    """

    def __init__(self, channels: int, momentum: float = 0.9, eps: float = 1e-5,
                 zero_init_scale: bool = False):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.update_stats = True
        self.distributed = False
        self.weight = nn.Parameter(torch.zeros(channels) if zero_init_scale
                                   else torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor, groups: int = 1, residual=None,
                relu: bool = False) -> torch.Tensor:
        """BN(x), then ``+ residual`` and a ReLU where given (a bottleneck's
        tail, a conv's activation).  Train mode on a CUDA tensor runs them as
        one fused pass after the statistics' (:meth:`fused_train`); elsewhere
        the add and the ReLU follow the BN's output in its dtype."""
        if self.training and x.is_cuda:
            return self.fused_train(x, groups, residual, relu)
        y = self._normalize(x, groups)
        if residual is not None:
            y = y + residual
        return F.relu(y) if relu else y

    def fused_train(self, x: torch.Tensor, groups: int = 1, residual=None,
                    relu: bool = False) -> torch.Tensor:
        """Train mode through ``batchnorm_kernels.batch_norm_train``: the
        kernels on a CUDA tensor, their plain versions on the CPU."""
        n = x.numel() // self.weight.shape[0] // groups
        if self.distributed:
            n *= torch.distributed.get_world_size()
        fin = bn_kernels.Finish(n, self.eps, self.momentum, self.update_stats,
                                self.running_mean, self.running_var)
        return bn_kernels.batch_norm_train(x, self.weight, self.bias, fin, groups, residual,
                                           relu, self.distributed)

    def _normalize(self, x: torch.Tensor, groups: int) -> torch.Tensor:
        dtype = x.dtype
        if not self.training:
            inv = (self.weight * torch.rsqrt(self.running_var + self.eps)).to(dtype)
            return ((x - _channel(self.running_mean.to(dtype))) * _channel(inv)
                    + _channel(self.bias.to(dtype)))
        b, c = x.shape[:2]
        if b % groups:
            raise ValueError(f"GroupedBatchNorm: batch {b} does not split into {groups} groups")
        xg = x.reshape((groups, b // groups) + tuple(x.shape[1:]))
        red = (1,) + tuple(range(3, xg.ndim))
        xf = xg.float()
        mean = xf.mean(dim=red)                                   # [G, C]
        msq = torch.square(xf).mean(dim=red)
        n = xg[0].numel() // c
        if self.distributed:
            world = torch.distributed.get_world_size()
            mean, msq = all_reduce_sum(torch.stack([mean, msq])) / world
            n *= world
        var = msq - torch.square(mean)
        inv = self.weight * torch.rsqrt(var + self.eps)
        shape = (groups, 1, c) + (1,) * (x.ndim - 2)
        y = ((xg - mean.reshape(shape).to(dtype)) * inv.reshape(shape).to(dtype)
             + self.bias.reshape(shape[1:]).to(dtype))
        if self.update_stats:
            with torch.no_grad():
                bessel = n / max(n - 1.0, 1.0)
                m = self.momentum
                run_mean, run_var = self.running_mean, self.running_var
                for g in range(groups):
                    run_mean = m * run_mean + (1 - m) * mean[g]
                    run_var = m * run_var + (1 - m) * var[g] * bessel
                self.running_mean.copy_(run_mean)
                self.running_var.copy_(run_var)
        return y.reshape(x.shape)


@contextlib.contextmanager
def _stats_frozen(module: nn.Module):
    """The BatchNorms of ``module`` leave their running stats alone inside."""
    bns = [m for m in module.modules() if isinstance(m, GroupedBatchNorm)]
    for bn in bns:
        bn.update_stats = False
    try:
        yield
    finally:
        for bn in bns:
            bn.update_stats = True


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

    def forward(self, x: torch.Tensor, groups: int = 1, residual=None) -> torch.Tensor:
        """``residual`` is added after the BN, before the ReLU."""
        x = F.conv2d(x.to(self.dtype), self.conv.weight.to(self.dtype), None,
                     self.stride, self.padding, self.dilation)
        return self.bn(x, groups, residual, self.relu).to(self.dtype)


class Bottleneck(nn.Module):
    """torchvision bottleneck: 1x1 -> 3x3 (stride, dilation) -> 1x1 x4.

    ``head`` (conv1, conv2) and ``tail`` (conv3, the shortcut, the add) are
    the two segments the ``save_mid`` remat policy checkpoints apart."""

    def __init__(self, in_ch: int, planes: int, stride: int = 1, dilation: int = 1,
                 has_downsample: bool = False, zero_init_residual: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        kw = dict(dtype=dtype)
        self.conv1 = ConvBN(in_ch, planes, 1, 1, 1, relu=True, **kw)
        self.conv2 = ConvBN(planes, planes, 3, stride, dilation, relu=True, **kw)
        self.conv3 = ConvBN(planes, planes * 4, 1, 1, 1, relu=True,     # after the add
                            zero_init_scale=zero_init_residual, **kw)
        self.downsample = (ConvBN(in_ch, planes * 4, 1, stride, 1, relu=False, **kw)
                           if has_downsample else None)

    def head(self, x: torch.Tensor, groups: int = 1) -> torch.Tensor:
        return self.conv2(self.conv1(x, groups), groups)

    def tail(self, mid: torch.Tensor, x: torch.Tensor, groups: int = 1) -> torch.Tensor:
        identity = self.downsample(x, groups) if self.downsample is not None else x
        return self.conv3(mid, groups, identity)

    def forward(self, x: torch.Tensor, groups: int = 1) -> torch.Tensor:
        return self.tail(self.head(x, groups), x, groups)


@dataclasses.dataclass(frozen=True)
class StageSpec:
    planes: int
    blocks: int
    stride: int
    first_dilation: int
    rest_dilation: int


class ResNetBackbone(nn.Module):
    """ResNet trunk returning (low-level /4 features, final features).

    ``deep_stem=False`` is torchvision's 7x7 stem and floor-mode max pool;
    ``deep_stem=True`` the reference ``ResNet_Stem``: three 3x3 convs to 128
    channels and a ceil-mode max pool.  ``remat`` is True (every stage), a
    tuple of 0-based stage indices, or False; ``remat_policy`` "nothing"
    recomputes whole blocks in backward, "save_mid" keeps each block's conv2
    output and recomputes its two halves apart.
    """

    def __init__(self, stages: Sequence[StageSpec], deep_stem: bool = False,
                 zero_init_residual: bool = False, dtype: torch.dtype = torch.float32,
                 remat: Union[bool, Tuple[int, ...]] = False, remat_policy: str = "nothing"):
        super().__init__()
        if remat_policy not in REMAT_POLICIES:
            raise ValueError(f"unknown remat_policy {remat_policy!r} (one of {REMAT_POLICIES})")
        self.stages = tuple(stages)
        self.deep_stem = deep_stem
        self.remat = tuple(remat) if isinstance(remat, (tuple, list)) else bool(remat)
        self.remat_policy = remat_policy
        if deep_stem:
            self.stem1 = ConvBN(3, 64, 3, 2, dtype=dtype)
            self.stem2 = ConvBN(64, 64, 3, 1, dtype=dtype)
            self.stem3 = ConvBN(64, 128, 3, 1, dtype=dtype)
            in_ch = 128
        else:
            self.stem = ConvBN(3, 64, 7, 2, dtype=dtype)
            in_ch = 64
        self.block_names = []
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
                    zero_init_residual=zero_init_residual, dtype=dtype))
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

    def low_level_hw(self, hw: Tuple[int, int]) -> Tuple[int, int]:
        """Spatial size of the low-level (/4) features for an input of ``hw``:
        the stride-2 stem conv, then the 3x3/2 max pool (ceil mode under the
        deep stem, so 32 -> 9 and 512 -> 129 there, 8 and 128 plain)."""
        def one(x):
            x = (x - 1) // 2 + 1                  # 7x7 pad 3 or 3x3 pad 1, stride 2
            if not self.deep_stem:
                return (x - 1) // 2 + 1
            out = -(-(x - 1) // 2) + 1            # torch's ceil mode: the last window
            return out - 1 if (out - 1) * 2 >= x + 1 else out   # starts inside
        return one(hw[0]), one(hw[1])

    def _remat_stage(self, si: int) -> bool:
        return si in self.remat if isinstance(self.remat, tuple) else self.remat

    def _block(self, block: Bottleneck, x: torch.Tensor, groups: int, remat: bool):
        if not (remat and torch.is_grad_enabled()):
            return block(x, groups)
        kw = dict(use_reentrant=False, preserve_rng_state=False,
                  context_fn=lambda: (contextlib.nullcontext(), _stats_frozen(block)))
        if self.remat_policy == "save_mid":
            mid = checkpoint(block.head, x, groups, **kw)
            return checkpoint(block.tail, mid, x, groups, **kw)
        return checkpoint(block, x, groups, **kw)

    def forward(self, x: torch.Tensor, groups: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.deep_stem:
            x = self.stem3(self.stem2(self.stem1(x, groups), groups), groups)
            x = F.max_pool2d(x, 3, 2, 1, ceil_mode=True)
        else:
            x = F.max_pool2d(self.stem(x, groups), 3, 2, 1, ceil_mode=False)
        low = None
        for si, names in enumerate(self.block_names):
            remat = self._remat_stage(si)
            for name in names:
                x = self._block(getattr(self, name), x, groups, remat)
            if si == 0:
                low = x
        return low, x


def _stage_specs(layers: Sequence[int], output_stride: int,
                 multi_grid: bool = False) -> Tuple[StageSpec, ...]:
    """Stage schedule, as ``css_tpu``'s.  Output stride 8, plain: the
    reference's re-dilation surgery (layer3 dilation 1 then 2, layer4 2 then
    4).  Output stride 8, multi-grid (deep stem): layer4 as three
    single-block stages at dilations 4, 8 and 16, named ``layer4_0``,
    ``layer5_0``, ``layer6_0`` as in Flax.  Output stride 16: layer3 keeps
    its stride, layer4 dilation 1 then 2; ``multi_grid`` is ignored there,
    so the deep stem's blocks are ``layer4_{0,1,2}``."""
    l1, l2, l3, l4 = layers
    head = (StageSpec(64, l1, 1, 1, 1), StageSpec(128, l2, 2, 1, 1))
    if output_stride == 8:
        head += (StageSpec(256, l3, 1, 1, 2),)
        if multi_grid:
            return head + tuple(StageSpec(512, 1, 1, d, d) for d in (4, 8, 16))
        return head + (StageSpec(512, l4, 1, 2, 4),)
    if output_stride == 16:
        return head + (StageSpec(256, l3, 2, 1, 1), StageSpec(512, l4, 1, 1, 2))
    raise ValueError(f"unsupported output_stride {output_stride} (8 or 16)")


def resnet101(output_stride: int = 8, dtype: torch.dtype = torch.float32, remat=False,
              remat_policy: str = "nothing") -> ResNetBackbone:
    """Plain-stem ResNet-101 trunk (torchvision weight-compatible)."""
    return ResNetBackbone(_stage_specs([3, 4, 23, 3], output_stride), dtype=dtype,
                          remat=remat, remat_policy=remat_policy)


def resnet101_stem(output_stride: int = 8, dtype: torch.dtype = torch.float32, remat=False,
                   remat_policy: str = "nothing") -> ResNetBackbone:
    """Deep-stem ResNet-101 trunk (reference ``ResNet_Stem``; multi-grid at
    output stride 8), its residual BNs' scales starting at zero."""
    return ResNetBackbone(_stage_specs([3, 4, 23, 3], output_stride, multi_grid=True),
                          deep_stem=True, zero_init_residual=True, dtype=dtype,
                          remat=remat, remat_policy=remat_policy)


def resnet_tiny(output_stride: int = 8, dtype: torch.dtype = torch.float32, remat=False,
                remat_policy: str = "nothing", deep_stem: bool = False) -> ResNetBackbone:
    """Miniature trunk (one block per stage, narrow) for tests; ``deep_stem``
    gives the reference's ``tiny_stem``."""
    if output_stride != 8:
        raise ValueError("tiny trunk only supports OS8")
    return ResNetBackbone((
        StageSpec(8, 1, 1, 1, 1),
        StageSpec(16, 1, 2, 1, 1),
        StageSpec(32, 1, 1, 1, 2),
        StageSpec(64, 1, 1, 2, 4),
    ), deep_stem=deep_stem, dtype=dtype, remat=remat, remat_policy=remat_policy)
