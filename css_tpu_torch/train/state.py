"""Train state of the port, counterpart of ``css_tpu/train/state.py``.

PyTorch idiom: the state holds live objects — the student, the teacher, the
optimizer — and the train step updates them in place.

* SGD with nesterov momentum 0.9 and coupled weight decay
  (``torch.optim.SGD``, the rule the JAX optax chain reproduces), with the
  learning rate set from ``poly_lr(step)`` before each step;
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
from css_tpu_torch.train.schedulers import poly_lr, teacher_ema_decay

__all__ = ["TrainState", "create_train_state", "ema_update"]


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
def ema_update(teacher: torch.nn.Module, student: torch.nn.Module, step: int,
               alpha: float = 0.99) -> None:
    """teacher <- decay * teacher + (1 - decay) * student, parameters only."""
    decay = teacher_ema_decay(step, alpha)
    t_params = list(teacher.parameters())
    torch._foreach_mul_(t_params, decay)
    torch._foreach_add_(t_params, [p.detach() for p in student.parameters()],
                        alpha=1.0 - decay)
