"""The fused BatchNorm kernels (``csrc/batchnorm_kernels.cu``) on the card,
against their plain versions and against ``GroupedBatchNorm``'s own code run
on the same CUDA tensors.  Marked ``gpu``; they skip without a card:

    python -m pytest --noconftest tests/test_torch_batchnorm_cuda.py -m gpu -q

Shapes: the main path's (VOC layer3's conv2 and conv3 with the shortcut,
Cityscapes' layer3 with its two groups, the ASPP pool's 1x1 map at n = 4 rows
a group, the decoder's 48-channel projection), f32 input, a C off the vector
width, a gradient that arrives as a channel slice.

Tolerances.  Against the plain versions (the same f32 arithmetic, sums in
another order): y and dx round once to bf16 from values a few f32 steps
apart, so they differ by at most one bf16 step (2^-8 of the value) where they
differ at all; dw, db and the running stats are f32 sums over up to 602,176
rows a group: 1e-4 of the norm.  Against the BN's law in float64 on the same
inputs: the kernels round y, dx and d_residual once to bf16, so each lies
within one bf16 step (2^-8) of it in norm (in f32, 2^-16: sums of a few
thousand f32 values), dw and db within 1e-4, and in bf16 no output lies
farther from it than the module's own code does, which rounds
three times to bf16 in forward (x - mean, the product, the sum; the add and
the ReLU again) and carries those roundings through autograd into the
gradients.  The running stats against the module's: 1e-4 (both take f32
sums).
"""

from __future__ import annotations

import copy

import pytest
import torch
import torch.distributed as dist
import torch.nn.functional as F

from css_tpu_torch.models.resnet import GroupedBatchNorm
from css_tpu_torch.ops.kernels import batchnorm_kernels as bk

BF16_STEP = 2.0 ** -8


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the BatchNorm kernels have no CPU mode)")
    bk.reset_launches()
    yield torch.device("cuda")
    bk.reset_launches()


def _bn(c: int, seed: int, device) -> GroupedBatchNorm:
    g = torch.Generator().manual_seed(seed)
    bn = GroupedBatchNorm(c)
    with torch.no_grad():
        bn.weight.copy_(torch.rand(c, generator=g) + 0.5)
        bn.bias.copy_(torch.rand(c, generator=g) - 0.5)
        bn.running_mean.copy_(torch.rand(c, generator=g) * 2 - 1)
        bn.running_var.copy_(torch.rand(c, generator=g) + 0.5)
    return bn.to(device)


def _inputs(shape, dtype, residual: bool, device, seed: int = 1):
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(shape, generator=g, device=device) * 1.5 + 0.3
    res = torch.randn(shape, generator=g, device=device) if residual else None
    cot = torch.randn(shape, generator=g, device=device)
    cl = torch.channels_last
    return (x.to(dtype).contiguous(memory_format=cl),
            None if res is None else res.to(dtype).contiguous(memory_format=cl), cot)


def _fused(bn, x, groups, res, relu):
    return bn(x, groups, res, relu)


def _plain_ops(bn, x, groups, res, relu):
    return bn.fused_train(x, groups, res, relu)


def _module_code(bn, x, groups, res, relu):
    y = bn._normalize(x, groups)
    if res is not None:
        y = y + res
    return F.relu(y) if relu else y


def _run(fn, bn, x, res, cot, groups, relu):
    x = x.clone().requires_grad_(True)
    res = None if res is None else res.clone().requires_grad_(True)
    y = fn(bn, x, groups, res, relu)
    (y.float() * cot).sum().backward()
    return dict(y=y.detach(), dx=x.grad, dw=bn.weight.grad, db=bn.bias.grad,
                running_mean=bn.running_mean, running_var=bn.running_var,
                **({} if res is None else {"dres": res.grad}))


def _gap(a, b) -> float:
    a, b = a.detach().double(), b.detach().double()
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


def _exact(bn, x, res, cot, groups, relu):
    """The BN's law (f32-free) in float64 autograd on the same inputs and
    the same cotangent as it reaches y (rounded to y's type)."""
    n, c = x.shape[:2]
    xd = x.double().requires_grad_(True)
    rd = None if res is None else res.double().requires_grad_(True)
    w, b = (t.detach().double().requires_grad_(True) for t in (bn.weight, bn.bias))
    xg = xd.reshape(groups, n // groups, *x.shape[1:])
    mean = xg.mean((1, 3, 4), keepdim=True)
    var = (xg * xg).mean((1, 3, 4), keepdim=True) - mean * mean
    y = ((xg - mean) * torch.rsqrt(var + bn.eps) * w.view(1, 1, c, 1, 1)
         + b.view(1, 1, c, 1, 1)).reshape(x.shape)
    if rd is not None:
        y = y + rd
    if relu:
        y = torch.relu(y)
    y.backward(cot.to(x.dtype).double())
    return dict(y=y.detach(), dx=xd.grad, dw=w.grad, db=b.grad,
                **({} if rd is None else {"dres": rd.grad}))


def _three_ways(shape, groups, residual, relu, dtype, device, monkeypatch, seed=1):
    x, res, cot = _inputs(shape, dtype, residual, device, seed)
    bn = _bn(shape[1], seed, device)
    plain_bn, module_bn = copy.deepcopy(bn), copy.deepcopy(bn)
    exact = _exact(bn, x, res, cot, groups, relu)
    got = _run(_fused, bn, x, res, cot, groups, relu)
    torch.cuda.synchronize()
    with monkeypatch.context() as m:
        m.setattr(bk, "_ops", lambda t: bk._PLAIN)
        plain = _run(_plain_ops, plain_bn, x, res, cot, groups, relu)
    module = _run(_module_code, module_bn, x, res, cot, groups, relu)
    return got, plain, module, exact


def _check(got, plain, module, exact, dtype):
    assert set(got) == set(plain) == set(module)
    assert got["y"].dtype == dtype
    assert got["y"].is_contiguous(memory_format=torch.channels_last)
    bf16 = dtype == torch.bfloat16
    step = BF16_STEP if bf16 else 2.0 ** -16
    for k in ("y", "dx", "dres"):
        if k in got:
            diff = (got[k].float() - plain[k].float()).abs()
            assert bool((diff <= step * plain[k].float().abs() + 1e-6).all()) or \
                _gap(got[k], plain[k]) <= step, k
    for k in ("dw", "db", "running_mean", "running_var"):
        assert _gap(got[k], plain[k]) <= 1e-4, k
    gaps = {k: (_gap(got[k], exact[k]), _gap(module[k], exact[k])) for k in exact}
    print("gap to float64 (kernels, module):", gaps)
    for k, (kernels, own) in gaps.items():
        assert kernels <= (step if k in ("y", "dx", "dres") else 1e-4), (k, gaps)
        assert kernels <= own or not bf16, (k, gaps)
    for k in ("running_mean", "running_var"):
        assert _gap(got[k], module[k]) <= 1e-4, k


MAIN_PATH = [
    pytest.param((8, 256, 64, 64), 1, False, True, id="voc_layer3_conv2"),
    pytest.param((8, 1024, 64, 64), 1, True, True, id="voc_layer3_conv3_residual"),
    pytest.param((8, 1024, 97, 97), 2, False, True, id="city_layer3_groups2"),
    pytest.param((8, 256, 1, 1), 2, False, True, id="aspp_pool_groups2"),
    pytest.param((8, 48, 128, 128), 1, False, True, id="decoder_projection_48"),
    pytest.param((8, 1024, 64, 64), 1, False, False, id="downsample_no_relu"),
]


@pytest.mark.gpu
@pytest.mark.parametrize("shape,groups,residual,relu", MAIN_PATH)
def test_kernels_at_the_main_path_shapes(cuda, monkeypatch, shape, groups, residual, relu):
    _check(*_three_ways(shape, groups, residual, relu, torch.bfloat16, cuda, monkeypatch),
           torch.bfloat16)
    assert bk.LAUNCHES == {"css_bn_stats": 1, "css_bn_finish": 0, "css_bn_apply": 1,
                           "css_bn_grad_stats": 1, "css_bn_grad_apply": 1}


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dtype", [
    pytest.param((4, 256, 32, 32), torch.float32, id="f32"),
    pytest.param((4, 5, 9, 7), torch.float32, id="f32_c5_scalar"),
    pytest.param((4, 12, 9, 7), torch.bfloat16, id="bf16_c12_scalar"),
])
def test_kernels_other_dtypes_and_widths(cuda, monkeypatch, shape, dtype):
    _check(*_three_ways(shape, 2, True, True, dtype, cuda, monkeypatch, seed=3), dtype)


@pytest.mark.gpu
def test_gradient_as_a_channel_slice(cuda, monkeypatch):
    """The decoder concatenates the projection's output: its gradient is a
    channel slice of a wider tensor, read in place by its row stride."""
    x, _, _ = _inputs((4, 48, 32, 32), torch.bfloat16, False, cuda, seed=5)
    other = torch.randn(4, 256, 32, 32, device=cuda).to(torch.bfloat16)
    cot = torch.randn(4, 304, 32, 32, device=cuda)
    outs = []
    for use_plain in (False, True):
        bn = _bn(48, 5, cuda)
        xi = x.clone().requires_grad_(True)
        with monkeypatch.context() as m:
            if use_plain:
                m.setattr(bk, "_ops", lambda t: bk._PLAIN)
            y = bn.fused_train(xi, 1, None, True)
            z = torch.cat([y, other.contiguous(memory_format=torch.channels_last)], dim=1)
            (z.float() * cot).sum().backward()
        outs.append((xi.grad, bn.weight.grad))
    assert _gap(outs[0][0], outs[1][0]) <= BF16_STEP
    assert _gap(outs[0][1], outs[1][1]) <= 1e-4


@pytest.mark.gpu
def test_update_stats_off_leaves_the_running_stats(cuda):
    x, res, cot = _inputs((8, 256, 16, 16), torch.bfloat16, True, cuda)
    bn = _bn(256, 1, cuda)
    before = bn.running_mean.clone(), bn.running_var.clone()
    bn.update_stats = False
    _run(_fused, bn, x, res, cot, 2, True)
    assert torch.equal(bn.running_mean, before[0]) and torch.equal(bn.running_var, before[1])


@pytest.mark.gpu
def test_remat_moves_each_running_stat_once(cuda):
    """The tiny trunk with remat on every stage against it without: the same
    output and the same running stats, bit for bit (the recompute's BNs run
    with update_stats off)."""
    from css_tpu_torch.models.deeplabv3 import build_model

    # deterministic f32 convolutions: cuDNN's TF32 off and its picks fixed
    torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32 = True, False
    try:
        outs = []
        for remat in (False, True):
            model = build_model(5, 8, "tiny", remat=remat).to(cuda).train()
            model = model.to(memory_format=torch.channels_last)
            img = torch.randn(4, 32, 32, 3, generator=torch.Generator().manual_seed(0)).to(cuda)
            pred, rep = model(img, bn_groups=2)
            (pred.sum() + rep.sum()).backward()
            outs.append((pred.detach(), [b.clone() for b in model.buffers()],
                         [p.grad.clone() for p in model.parameters()]))
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32 = False, True
    assert torch.equal(outs[0][0], outs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(outs[0][1], outs[1][1]))
    # the gradients as one vector: a leaf whose gradient nearly cancels (a
    # bias under a BN) reads the upsampling backward's atomics in its last bits
    flat = [torch.cat([g.flatten() for g in out[2]]) for out in outs]
    print("remat: gradient gap", _gap(flat[1], flat[0]), "worst leaf",
          max(_gap(a, b) for a, b in zip(outs[0][2], outs[1][2])))
    assert _gap(flat[1], flat[0]) <= 1e-5


@pytest.mark.gpu
def test_two_runs_equal_bits_and_no_sync(cuda):
    x, res, cot = _inputs((8, 1024, 64, 64), torch.bfloat16, True, cuda, seed=7)
    bns = [_bn(1024, 7, cuda) for _ in range(2)]
    runs = []
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for bn in bns:
            runs.append(_run(_fused, bn, x, res, cot, 2, True))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for k in runs[0]:
        assert torch.equal(runs[0][k], runs[1][k]), k


@pytest.mark.gpu
def test_distributed_one_rank_nccl(cuda, tmp_path):
    """A one-rank NCCL group: the sums go through the all-reduce and the
    statistics finish in a launch of their own, to the same bits."""
    if dist.is_initialized():
        pytest.skip("a process group is already up in this process")
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/rendezvous", rank=0,
                            world_size=1)
    try:
        x, res, cot = _inputs((8, 1024, 64, 64), torch.bfloat16, True, cuda, seed=9)
        plain = _run(_fused, _bn(1024, 9, cuda), x, res, cot, 2, True)
        bk.reset_launches()
        bn = _bn(1024, 9, cuda)
        bn.distributed = True
        got = _run(_fused, bn, x, res, cot, 2, True)
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    assert bk.LAUNCHES == {"css_bn_stats": 1, "css_bn_finish": 1, "css_bn_apply": 1,
                           "css_bn_grad_stats": 1, "css_bn_grad_apply": 1}
    for k in plain:
        assert torch.equal(got[k], plain[k]), k


@pytest.mark.gpu
def test_what_the_kernels_refuse_raises(cuda):
    bn = _bn(8, 0, cuda)
    nchw = torch.randn(2, 8, 4, 4, device=cuda)
    with pytest.raises(ValueError, match="channels-last"):
        bn(nchw)
    with pytest.raises(TypeError, match="bf16 or f32"):
        bn(nchw.half().contiguous(memory_format=torch.channels_last))
    with pytest.raises(ValueError, match="does not split"):
        bn(nchw.contiguous(memory_format=torch.channels_last), 3)
    assert bk.LAUNCHES == dict.fromkeys(bk.LAUNCHES, 0)


@pytest.mark.gpu
def test_tiny_train_step_takes_the_kernels(cuda):
    """Every train-mode BN of the tiny trunk's ``ori`` step, student and
    teacher, runs through the kernels: a forward pre-hook counts the
    train-mode calls on the card in the first (eager) step, and each
    launched the statistics and the output kernel once, and the two backward
    kernels once where it built a graph (the student's); none took another
    path.  The next two steps (a CUDA graph's capture, then a replay) call
    the wrappers once more, in the capture: the counters count calls, and a
    replay makes none."""
    import importlib.util
    from pathlib import Path

    # by path: the card machine may have another package named ``tests``
    path = Path(__file__).with_name("test_torch_profiling.py")
    spec = importlib.util.spec_from_file_location("_torch_profiling_tests", path)
    profiling_tests = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(profiling_tests)
    counts = {"calls": 0, "graphs": 0}

    def count(module, args):
        if isinstance(module, GroupedBatchNorm) and module.training and args[0].is_cuda:
            counts["calls"] += 1
            counts["graphs"] += torch.is_grad_enabled() and any(
                t.requires_grad for t in (args[0], module.weight, module.bias))

    run = profiling_tests.TinyRun(cuda)
    try:
        n_bn = sum(isinstance(m, GroupedBatchNorm) for m in run.state.model.modules())
        handle = torch.nn.modules.module.register_module_forward_pre_hook(count)
        try:
            run.step()
        finally:
            handle.remove()
        torch.cuda.synchronize()
        one_step = dict(bk.LAUNCHES)
        bk.reset_launches()
        for _ in range(2):
            run.step()
        torch.cuda.synchronize()
        assert run.step_fn.graphs.replays == 2
    finally:
        run.close()
    calls, graphs = counts["calls"], counts["graphs"]
    assert calls >= 2 * n_bn and calls % n_bn == 0        # teacher and student
    assert graphs >= n_bn and graphs % n_bn == 0          # the student's
    assert one_step == {"css_bn_stats": calls, "css_bn_finish": 0, "css_bn_apply": calls,
                        "css_bn_grad_stats": graphs, "css_bn_grad_apply": graphs}
    assert bk.LAUNCHES == one_step
