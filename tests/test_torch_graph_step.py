"""What the train step's CUDA graphs need of it, on the CPU: no tensor made
from host numbers and no ``bincount`` inside the step (each drains the card's
stream, and a capture refuses it), the per-step numbers as tensors equal to
the Python numbers they replace, and the SGD and EMA updates that take them
equal to ``torch.optim.SGD``'s and to the Python-number EMA bit for bit.  The
graphs themselves run on the card only (``test_torch_graph_step_cuda.py``);
on the CPU the step stays eager."""

from __future__ import annotations

import contextlib

import numpy as np
import pytest
import torch

from css_tpu_torch.losses.contrastive import grouped_random_order
from css_tpu_torch.models.deeplabv3 import build_model
from css_tpu_torch.ops import augment, photometric
from css_tpu_torch.ops.photometric import device_constant
from css_tpu_torch.train import train_step
from css_tpu_torch.train.schedulers import poly_lr, rampdown_value, teacher_ema_decay
from css_tpu_torch.train.state import create_train_state, ema_update, sgd_step
from tests.test_torch_profiling import TinyRun


@pytest.mark.parametrize("values", [photometric._LUMA, augment.IMAGENET_MEAN,
                                    augment.IMAGENET_STD, (512, 512)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64, torch.int64])
def test_cached_constants_equal_the_old_ones(values, dtype):
    got = device_constant(values, dtype, torch.device("cpu"))
    want = torch.tensor(values, dtype=dtype)
    assert got.dtype == dtype and torch.equal(got, want)
    assert got.view(torch.uint8).tolist() == want.view(torch.uint8).tolist()
    assert device_constant(values, dtype, "cpu") is got          # one tensor per (device, dtype)


def test_a_constant_made_in_inference_mode_serves_autograd():
    with torch.inference_mode():
        c = device_constant((0.25, 0.5, 2.0), torch.float32, "cpu")
    x = torch.ones(3, requires_grad=True)
    (x * c).sum().backward()
    assert not c.is_inference() and torch.equal(x.grad, c)


@pytest.mark.parametrize("seed", range(4))
def test_fixed_length_counts_equal_bincount(seed):
    g = torch.Generator().manual_seed(seed)
    c, n = 7, 500
    cls_id = torch.randint(0, c, (n,), generator=g)
    cls_id[cls_id == 3] = 5                  # class 3 empty
    member = torch.rand(n, generator=g) < 0.6
    if seed == 3:
        member[:] = False                     # every pixel in the non-member bin
    tie = torch.randint(0, 1 << 24, (n,), generator=g, dtype=torch.int32)
    order, counts, offsets = grouped_random_order(cls_id, member, tie, c)
    key = torch.where(member, cls_id, torch.full_like(cls_id, c))
    want = torch.bincount(key, minlength=c + 1)
    assert counts.dtype == torch.int64 and torch.equal(counts, want[:c])
    assert counts[3] == 0 and int(want[c]) == int((~member).sum())
    assert torch.equal(offsets, torch.cumsum(want[:c], 0) - want[:c])


def test_a_cpu_step_makes_no_host_tensor_and_no_bincount(monkeypatch):
    run = TinyRun(torch.device("cpu"))
    try:
        run.step()              # the cached constants are made here, once
        inside = []
        real_span, real_tensor, real_bincount = train_step.span, torch.tensor, torch.bincount

        @contextlib.contextmanager
        def marking(name, device=True):
            inside.append(name)
            try:
                with real_span(name, device):
                    yield
            finally:
                inside.pop()

        def refusing(real):
            def call(*args, **kwargs):
                if "css.step" in inside:
                    raise AssertionError(f"{real.__name__} inside css.step")
                return real(*args, **kwargs)
            return call

        monkeypatch.setattr(train_step, "span", marking)
        monkeypatch.setattr(torch, "tensor", refusing(real_tensor))
        monkeypatch.setattr(torch, "bincount", refusing(real_bincount))
        metrics = run.step()
        assert all(np.isfinite(float(v)) for v in metrics.values())
        assert run.state.step == 2 and run.step_fn.graphs.captures == 0   # eager on the CPU
    finally:
        run.close()


@pytest.mark.parametrize("weight", [1.0, 0.75, rampdown_value(3, 0, 10, 1.0, 0.0, -5.0)])
def test_step_scalars_equal_the_python_numbers(weight):
    total = 1000
    state = create_train_state(build_model(6, 16, "tiny"), 6, 16, base_lr=6.4e-3,
                               weight_decay=5e-4, total_steps=total, device="cpu")
    s = train_step._StepScalars(torch.device("cpu"))
    for k in (0, 1, 99, 100, total - 1):
        state.step = k
        lr = s.write(state, 0.99, weight)
        assert lr == poly_lr(k, 6.4e-3, total) == state.lr_schedule(k)
        assert s.lr.dtype == torch.float32 and s.lr.item() == lr
        decay = teacher_ema_decay(k, 0.99)
        assert s.decay.item() == decay
        assert s.rest.item() == float(np.float32(1.0 - decay))
        assert s.weight.item() == float(np.float32(weight))


def _params(seed):
    g = torch.Generator().manual_seed(seed)
    shapes = [(33,), (16, 8, 3, 3), (7, 5), (1,), (64,)]
    return [torch.nn.Parameter(torch.randn(s, generator=g)) for s in shapes]


@pytest.mark.parametrize("wd,nesterov", [(5e-4, True), (0.0, True), (5e-4, False)])
def test_sgd_step_equals_torch_sgd(wd, nesterov):
    mine, theirs = _params(0), _params(0)
    kw = dict(lr=1.0, momentum=0.9, weight_decay=wd, nesterov=nesterov)
    opt_mine, opt_theirs = torch.optim.SGD(mine, **kw), torch.optim.SGD(theirs, **kw)
    g = torch.Generator().manual_seed(1)
    for k in range(3):
        lr = poly_lr(k * 40, 6.4e-3, 100)
        for a, b in zip(mine, theirs):
            a.grad = torch.randn(a.shape, generator=g)
            b.grad = a.grad.clone()
        for group in opt_theirs.param_groups:
            group["lr"] = lr
        opt_theirs.step()
        sgd_step(opt_mine, torch.tensor(lr))
    for a, b in zip(mine, theirs):
        assert torch.equal(a, b)
        assert torch.equal(opt_mine.state[a]["momentum_buffer"],
                           opt_theirs.state[b]["momentum_buffer"])


def test_ema_update_equals_the_python_number_law():
    teacher, student = torch.nn.Linear(9, 5), torch.nn.Linear(9, 5)
    want = [p.detach().clone() for p in teacher.parameters()]
    for k in (0, 1, 99):
        decay = teacher_ema_decay(k, 0.99)
        for t, p in zip(want, student.parameters()):
            t.mul_(decay).add_(p.detach(), alpha=1.0 - decay)
        ema_update(teacher, student, torch.tensor(decay), torch.tensor(1.0 - decay))
        assert all(torch.equal(a, b) for a, b in zip(teacher.parameters(), want))
