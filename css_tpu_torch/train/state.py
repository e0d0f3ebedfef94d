"""Train state of the port, counterpart of ``css_tpu/train/state.py``.

PyTorch idiom: the state holds live objects — the student, the teacher, the
optimizer — and the train step updates them in place.

* SGD with nesterov momentum 0.9 and coupled weight decay, the rule the JAX
  optax chain reproduces: ``torch.optim.SGD`` holds the hyper-parameters and
  the momentum buffers, and ``sgd_step`` applies its update with the
  learning rate (``poly_lr(step)``) a tensor on the card;
* the teacher starts as a copy of the student; its EMA covers parameters
  only, and its BatchNorm running stats move only through its own
  train-mode forward;
* prototypes start as zeros [C, D];
* ``consumed`` is set when a train step failed at or after its commit (the
  SGD update) and the state is half-updated: the step refuses it until the
  driver copies a host snapshot back (``cli/train_main.py``), as a JAX step
  refuses donated buffers that are already deleted.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
from typing import Callable

import torch

from css_tpu_torch import resolve_device
from css_tpu_torch.models.deeplabv3 import DeepLabV3PlusDual
from css_tpu_torch.train.schedulers import poly_lr

__all__ = ["TrainState", "create_train_state", "ema_update", "sgd_step"]


@dataclasses.dataclass
class TrainState:
    step: int
    model: DeepLabV3PlusDual        # student
    teacher: DeepLabV3PlusDual      # EMA teacher (no grad)
    optimizer: torch.optim.SGD
    lr_schedule: Callable[[int], float]
    prototypes: torch.Tensor        # [C, D] f32
    consumed: bool = False          # a step failed at or after its commit


def create_train_state(model: DeepLabV3PlusDual, num_classes: int, output_dim: int = 256, *,
                       base_lr: float, weight_decay: float, total_steps: int,
                       power: float = 0.9, min_lr: float = 1e-4, momentum: float = 0.9,
                       device="cuda") -> TrainState:
    """Moves ``model`` to ``device`` (channels-last on the card) and builds
    the teacher, the optimizer and zero prototypes."""
    dev = resolve_device(device)
    model = model.to(dev)
    if dev.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    teacher = copy.deepcopy(model)
    teacher.requires_grad_(False)
    schedule = functools.partial(poly_lr, base_lr=base_lr, total_steps=total_steps,
                                 power=power, min_lr=min_lr)
    optimizer = torch.optim.SGD(model.parameters(), lr=schedule(0), momentum=momentum,
                                nesterov=True, weight_decay=weight_decay)
    return TrainState(step=0, model=model, teacher=teacher, optimizer=optimizer,
                      lr_schedule=schedule,
                      prototypes=torch.zeros(num_classes, output_dim, device=dev))


@torch.no_grad()
def ema_update(teacher: torch.nn.Module, student: torch.nn.Module, decay: torch.Tensor,
               rest: torch.Tensor) -> None:
    """teacher <- decay * teacher + rest * student, parameters only.  ``decay``
    (``teacher_ema_decay``) and ``rest`` (1 - decay, rounded to f32 as a
    Python number operand is) are 0-dim f32 tensors on the parameters'
    device: the same products as with Python numbers, without a value the
    host has to know when it issues them."""
    t_params = list(teacher.parameters())
    torch._foreach_mul_(t_params, decay)
    torch._foreach_addcmul_(t_params, [p.detach() for p in student.parameters()],
                            [rest] * len(t_params))


@torch.no_grad()
def sgd_step(optimizer: torch.optim.SGD, lr: torch.Tensor) -> None:
    """``optimizer.step()`` with the learning rate ``lr`` a 0-dim f32 tensor
    on the parameters' device (SGD's own turns a tensor rate into a host
    number): torch.optim.SGD's update (coupled weight decay, momentum,
    dampening, nesterov) in its order of operations, as ``_foreach_`` ops.
    The momentum buffers stay in ``optimizer.state[p]["momentum_buffer"]``,
    made from the first step's gradients as SGD makes them."""
    for group in optimizer.param_groups:
        if group.get("maximize"):
            raise ValueError("sgd_step: maximize is not supported")
        params = [p for p in group["params"] if p.grad is not None]
        if not params:
            continue
        grads = [p.grad for p in params]
        wd, momentum = group["weight_decay"], group["momentum"]
        if wd != 0:
            grads = torch._foreach_add(grads, params, alpha=wd)
        if momentum != 0:
            states = [optimizer.state[p] for p in params]
            bufs = [st.get("momentum_buffer") for st in states]
            if any(b is None for b in bufs):
                for i, (st, g) in enumerate(zip(states, grads)):
                    if bufs[i] is None:
                        bufs[i] = st["momentum_buffer"] = g.detach().clone()
                    else:
                        bufs[i].mul_(momentum).add_(g, alpha=1 - group["dampening"])
            else:
                torch._foreach_mul_(bufs, momentum)
                torch._foreach_add_(bufs, grads, alpha=1 - group["dampening"])
            if not group["nesterov"]:
                grads = bufs
            elif wd != 0:       # grads is SGD's own copy: add in place, as SGD does
                torch._foreach_add_(grads, bufs, alpha=momentum)
            else:
                grads = torch._foreach_add(grads, bufs, alpha=momentum)
        # param - lr * grad: SGD's add with alpha=-lr, bit for bit on the CPU;
        # on CUDA the product is rounded before the add, which SGD's fuses
        torch._foreach_addcmul_(params, grads, [lr] * len(params), value=-1)
