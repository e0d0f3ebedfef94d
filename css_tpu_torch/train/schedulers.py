"""Closed-form schedules, counterpart of ``css_tpu/train/schedulers.py``.

All are evaluated in float32, as the JAX functions are, and returned as
Python floats: the per-iteration poly LR, the per-epoch ramps of the
contrastive weight (``mix`` and ``cross`` use the ramp-down) and the
teacher's EMA decay.
"""

from __future__ import annotations

import numpy as np

__all__ = ["poly_lr", "rampdown_value", "ramp_up_value", "teacher_ema_decay"]


def poly_lr(step: int, base_lr: float, total_steps: int, power: float = 0.9,
            min_lr: float = 1e-4) -> float:
    """Per-iteration polynomial decay with a floor (the reference's PolyLR)."""
    f32 = np.float32
    frac = f32(1.0) - f32(step) / f32(total_steps)
    return float(np.maximum(f32(base_lr) * np.maximum(frac, f32(0.0)) ** f32(power),
                            f32(min_lr)))


def _ramp_frac(epoch: int, begin_epoch: int, max_epoch: int):
    f32 = np.float32
    return f32(epoch), (f32(epoch) - f32(begin_epoch)) / f32(max(max_epoch - begin_epoch, 1))


def rampdown_value(epoch: int, begin_epoch: int, max_epoch: int, max_value: float,
                   min_value: float, ramp_mult: float) -> float:
    """max_value * exp(ramp_mult * frac^2) over [begin, max), 0 before it,
    min_value from max_epoch on, never below min_value."""
    f32 = np.float32
    e, frac = _ramp_frac(epoch, begin_epoch, max_epoch)
    val = f32(max_value) * np.exp(f32(ramp_mult) * frac ** 2)
    if e < begin_epoch:
        val = f32(0.0)
    elif e >= max_epoch:
        val = f32(min_value)
    return float(np.maximum(val, f32(min_value)))


def ramp_up_value(epoch: int, begin_epoch: int, max_epoch: int, max_value: float,
                  ramp_mult: float) -> float:
    """max_value * exp(ramp_mult * (1 - frac)^2) over [begin, max), 0 before
    it, max_value from max_epoch on."""
    f32 = np.float32
    e, frac = _ramp_frac(epoch, begin_epoch, max_epoch)
    if e < begin_epoch:
        return 0.0
    if e >= max_epoch:
        return float(f32(max_value))
    return float(f32(max_value) * np.exp(f32(ramp_mult) * (f32(1.0) - frac) ** 2))


def teacher_ema_decay(step: int, alpha: float = 0.99) -> float:
    """min(1 - 1/(step+1), alpha) — the reference's teacher EMA decay."""
    f32 = np.float32
    return float(np.minimum(f32(1.0) - f32(1.0) / (f32(step) + f32(1.0)), f32(alpha)))
