"""Full-state checkpoints, counterpart of ``css_tpu/train/checkpoint.py``.

One ``torch.save`` of one dict holds what the reference saves: the step,
the epoch, the mIoU stamp, the student's, the teacher's and the optimizer's
``state_dict()``s, and the prototypes.  The learning rate is a function of
the step, so no scheduler state is needed.  A save writes a temporary file
and renames it over the target, so a reader never sees half a checkpoint.
A ResNet-101 save is about 0.7 GB (student, teacher and momentum).
"""

from __future__ import annotations

import hashlib
import os
from typing import Tuple

import torch

from css_tpu_torch.train.state import TrainState

__all__ = ["save_checkpoint", "restore_checkpoint", "load_prototypes", "state_sha256"]


def save_checkpoint(path: str, state: TrainState, epoch: int, miou: float) -> None:
    """Atomic full-state save to the file ``path``."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    payload = {
        "step": int(state.step),
        "epoch": int(epoch),
        "miou": float(miou),
        "model": state.model.state_dict(),
        "teacher": state.teacher.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "prototypes": state.prototypes,
    }
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        torch.save(payload, tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load(path: str, state: TrainState) -> dict:
    return torch.load(path, map_location=state.prototypes.device, weights_only=True)


def restore_checkpoint(path: str, state: TrainState) -> Tuple[TrainState, int, float]:
    """Loads the checkpoint at ``path`` into ``state`` (on its device);
    returns (state, epoch, miou)."""
    payload = _load(path, state)
    state.model.load_state_dict(payload["model"])
    state.teacher.load_state_dict(payload["teacher"])
    state.optimizer.load_state_dict(payload["optimizer"])
    state.prototypes = payload["prototypes"]
    state.step = int(payload["step"])
    return state, int(payload["epoch"]), float(payload["miou"])


def load_prototypes(path: str, state: TrainState) -> TrainState:
    """Seeds only the prototypes from another run's checkpoint."""
    state.prototypes = _load(path, state)["prototypes"]
    return state


def state_sha256(state: TrainState) -> str:
    """SHA-256 of what a checkpoint of ``state`` holds: the step, the
    student's and the teacher's tensors, the momentum buffers and the
    prototypes, each in its logical (contiguous) element order.  Replicas
    that agree bit for bit have the same digest."""
    h = hashlib.sha256(str(int(state.step)).encode())
    momentum = [state.optimizer.state.get(p, {}).get("momentum_buffer")
                for p in state.model.parameters()]
    tensors = (list(state.model.state_dict().values()) + list(state.teacher.state_dict().values())
               + [m for m in momentum if m is not None] + [state.prototypes])
    for t in tensors:
        h.update(t.detach().contiguous().reshape(-1).cpu().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()
