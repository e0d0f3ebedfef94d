"""The fused train-mode BatchNorm (``ops/kernels/batchnorm_kernels.py``) on
the CPU: its plain functions, which compute the CUDA kernels' arithmetic,
through its autograd function, against autograd of ``GroupedBatchNorm``'s
own code; the dispatch (CPU tensors keep the module's code and never load the
library); the bottleneck's tail with the shortcut handed to ``conv3`` bit for
bit as before; the launch grid and the row layouts the kernels take.

Tolerances.  In f32 the two paths differ in the order of their sums and in
how the gradient is formed (autograd through mean, E[x^2] and the normalise
against the closed form): a few f32 roundings, 1e-6 of the norm.  In bf16 the
module rounds three times to bf16 (x - mean, the product, the sum; the add
and the ReLU round again) where the plain functions round once, so the two
differ by about one bf16 step (2^-8 = 0.4%) of the norm: 1.5e-2.
"""

from __future__ import annotations

import copy
import dataclasses

import pytest
import torch
import torch.distributed as dist
import torch.nn.functional as F

from css_tpu_torch.models.deeplabv3 import build_model
from css_tpu_torch.models.resnet import Bottleneck, GroupedBatchNorm
from css_tpu_torch.ops.kernels import _build
from css_tpu_torch.ops.kernels import batchnorm_kernels as bk

SHAPE = (4, 6, 3, 5)
RTOL = {torch.float32: 1e-6, torch.bfloat16: 1.5e-2}


def _bn(seed: int) -> GroupedBatchNorm:
    g = torch.Generator().manual_seed(seed)
    bn = GroupedBatchNorm(SHAPE[1])
    with torch.no_grad():
        bn.weight.copy_(torch.rand(SHAPE[1], generator=g) + 0.5)
        bn.bias.copy_(torch.rand(SHAPE[1], generator=g) - 0.5)
        bn.running_mean.copy_(torch.rand(SHAPE[1], generator=g) * 2 - 1)
        bn.running_var.copy_(torch.rand(SHAPE[1], generator=g) + 0.5)
    return bn


def _gap(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.detach().double(), b.detach().double()
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


def _run(fn, bn, x, residual, cot, groups, relu):
    """Output and gradients of sum(y * cot) through ``fn``."""
    x = x.clone().requires_grad_(True)
    res = None if residual is None else residual.clone().requires_grad_(True)
    y = fn(bn, x, groups, res, relu)
    (y.float() * cot).sum().backward()
    return dict(y=y, dx=x.grad, dw=bn.weight.grad, db=bn.bias.grad,
                running_mean=bn.running_mean, running_var=bn.running_var,
                **({} if res is None else {"dres": res.grad}))


def _module(bn, x, groups, residual, relu):
    return bn(x, groups, residual, relu)


def _fused(bn, x, groups, residual, relu):
    return bn.fused_train(x, groups, residual, relu)


def _inputs(dtype, residual: bool, seed: int = 1):
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(SHAPE, generator=g) * 2 + 0.5).to(dtype)
    res = torch.randn(SHAPE, generator=g).to(dtype) if residual else None
    return x, res, torch.randn(SHAPE, generator=g)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("residual,relu", [(False, False), (False, True), (True, True)],
                         ids=["bn", "bn_relu", "bn_add_relu"])
@pytest.mark.parametrize("update", [True, False], ids=["update", "frozen"])
def test_plain_matches_module_autograd(dtype, groups, residual, relu, update):
    x, res, cot = _inputs(dtype, residual)
    bn = _bn(0)
    bn.update_stats = update
    fused = copy.deepcopy(bn)
    want = _run(_module, bn, x, res, cot, groups, relu)
    got = _run(_fused, fused, x, res, cot, groups, relu)
    assert got["y"].dtype == dtype and got["y"].shape == SHAPE
    assert set(got) == set(want)
    for k in want:
        assert _gap(got[k], want[k]) <= RTOL[dtype], k
    if not update:
        initial = _bn(0)
        assert torch.equal(fused.running_mean, initial.running_mean)
        assert torch.equal(fused.running_var, initial.running_var)


def test_plain_residual_without_relu():
    x, res, cot = _inputs(torch.float32, True, seed=2)
    bn = _bn(3)
    want = _run(_module, copy.deepcopy(bn), x, res, cot, 2, False)
    got = _run(_fused, bn, x, res, cot, 2, False)
    for k in want:
        assert _gap(got[k], want[k]) <= RTOL[torch.float32], k
    assert torch.equal(got["dres"], cot)


def test_plain_steps_in_the_kernels_order():
    """The plain functions chained by hand give what the autograd function
    gives: stats then apply forward, grad_stats then grad_apply backward."""
    x, res, cot = _inputs(torch.float32, True, seed=4)
    bn = _bn(5)
    got = _run(_fused, copy.deepcopy(bn), x, res, cot, 2, True)
    fin = bk.Finish(SHAPE[0] // 2 * SHAPE[2] * SHAPE[3], bn.eps, bn.momentum, True,
                    bn.running_mean.clone(), bn.running_var.clone())
    sums, stat = bk.stats_plain(x, 2, fin)
    assert torch.equal(stat, bk.finish_plain(sums, dataclasses.replace(fin, update=False)))
    y = bk.apply_plain(x, stat, bn.weight.detach(), bn.bias.detach(), 2, res, True)
    assert torch.equal(y, got["y"].detach())
    gsums, dw, db = bk.grad_stats_plain(x, cot, y, stat, 2)
    dx, dres = bk.grad_apply_plain(x, cot, y, stat, bn.weight.detach(), gsums, fin.n, 2, True)
    for k, v in dict(dx=dx, dres=dres, dw=dw, db=db, running_mean=fin.running_mean,
                     running_var=fin.running_var).items():
        assert torch.equal(v, got[k]), k


def test_distributed_one_rank_matches_module(tmp_path):
    """``distributed``: the sums go through the all-reduce (one gloo rank
    here), as the module's mean and E[x^2] do."""
    if dist.is_initialized():
        pytest.skip("a process group is already up in this process")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rendezvous", rank=0,
                            world_size=1)
    try:
        x, res, cot = _inputs(torch.float32, True, seed=6)
        bn = _bn(7)
        bn.distributed = True
        want = _run(_module, copy.deepcopy(bn), x, res, cot, 2, True)
        got = _run(_fused, bn, x, res, cot, 2, True)
    finally:
        dist.destroy_process_group()
    for k in want:
        assert _gap(got[k], want[k]) <= RTOL[torch.float32], k


def test_cpu_tensors_never_load_the_library(monkeypatch):
    def refuse(source):
        raise AssertionError(f"loaded {source} for CPU tensors")

    monkeypatch.setattr(_build, "load_library", refuse)
    monkeypatch.setattr(bk, "load_library", refuse)
    bk.reset_launches()
    model = build_model(5, 8, "tiny_stem", remat=True).train()
    pred, rep = model(torch.randn(4, 32, 32, 3), bn_groups=2)
    (pred.sum() + rep.sum()).backward()
    x, res, cot = _inputs(torch.float32, True)
    _run(_fused, _bn(0), x, res, cot, 1, True)
    assert bk.LAUNCHES == dict.fromkeys(bk.LAUNCHES, 0)


def _old_tail(blk: Bottleneck, mid, x, groups):
    """The tail as it was: conv3's BN without a ReLU, the shortcut, then
    F.relu(out + identity)."""
    c3 = blk.conv3
    out = F.conv2d(mid.to(c3.dtype), c3.conv.weight.to(c3.dtype), None, c3.stride, c3.padding,
                   c3.dilation)
    out = c3.bn(out, groups).to(c3.dtype)
    identity = blk.downsample(x, groups) if blk.downsample is not None else x
    return F.relu(out + identity)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("downsample", [False, True], ids=["identity", "downsample"])
@pytest.mark.parametrize("groups", [1, 2])
def test_bottleneck_tail_bit_identical(dtype, downsample, groups):
    torch.manual_seed(11)
    blk = Bottleneck(16 if downsample else 8, 2, stride=2 if downsample else 1,
                     has_downsample=downsample, dtype=dtype).train()
    old = copy.deepcopy(blk)
    g = torch.Generator().manual_seed(12)
    x = torch.randn(4, blk.conv1.conv.weight.shape[1], 6, 6, generator=g).to(dtype)
    outs = []
    for b, tail in ((blk, Bottleneck.tail), (old, _old_tail)):
        xi = x.clone().requires_grad_(True)
        mid = b.head(xi, groups)
        y = tail(b, mid, xi, groups)
        (y.float() * torch.linspace(-1, 1, y.numel()).view(y.shape)).sum().backward()
        outs.append([y, xi.grad] + [p.grad for p in b.parameters()] + list(b.buffers()))
    for got, want in zip(*outs):
        assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("shape,groups,dtype", [
    ((8, 256, 64, 64), 1, torch.bfloat16),       # VOC layer3 conv2
    ((8, 1024, 64, 64), 1, torch.bfloat16),      # VOC layer3 conv3
    ((8, 1024, 97, 97), 2, torch.bfloat16),      # Cityscapes layer3, the fused forward
    ((8, 256, 1, 1), 2, torch.bfloat16),         # the ASPP pool
    ((8, 64, 256, 256), 1, torch.bfloat16),      # the plain stem
    ((8, 48, 128, 128), 1, torch.float32),       # the decoder's projection, f32
    ((3, 5, 7, 7), 1, torch.float32),            # a C off the vector width
])
def test_grid_covers_every_row_once(shape, groups, dtype):
    n, c, h, w = shape
    rows = n * h * w // groups
    for vec in (True, False):
        tiles = -(-c // (bk.THREADS_X * (bk._VEC[dtype] if vec else 1)))
        chunks, per = bk.grid(rows, groups, tiles, 132)
        assert 1 <= chunks <= bk.MAX_CHUNKS and groups * chunks <= 65535
        assert per * chunks >= rows > per * (chunks - 1)          # every row, no empty chunk
        assert per >= min(bk.MIN_CHUNK_ROWS, rows)
        assert chunks == 1 or tiles * groups * (chunks - 1) < bk.BLOCKS_PER_SM * 132


def test_row_stride_reads_channels_last_rows():
    x = torch.randn(2, 6, 3, 5)
    assert bk.row_stride(x) is None                              # NCHW
    cl = x.contiguous(memory_format=torch.channels_last)
    assert bk.row_stride(cl) == 6
    wide = torch.cat([cl, cl], dim=1)                            # a channel slice of a wider tensor
    assert wide.is_contiguous(memory_format=torch.channels_last)
    assert bk.row_stride(wide[:, 6:]) == 12 and bk.row_stride(wide[:, :6]) == 12
    pooled = torch.randn(4, 6, 1, 1)                             # both layouts at 1x1
    assert bk.row_stride(pooled) == 6
    assert bk.row_stride(pooled.contiguous(memory_format=torch.channels_last)) == 6
    assert bk.row_stride(cl[:, :, ::2]) is None                  # rows not evenly spaced
