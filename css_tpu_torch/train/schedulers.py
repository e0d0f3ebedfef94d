"""Closed-form schedules, counterpart of ``css_tpu/train/schedulers.py``.

Both are evaluated in float32, as the JAX functions are, and returned as
Python floats.
"""

from __future__ import annotations

import numpy as np

__all__ = ["poly_lr", "teacher_ema_decay"]


def poly_lr(step: int, base_lr: float, total_steps: int, power: float = 0.9,
            min_lr: float = 1e-4) -> float:
    """Per-iteration polynomial decay with a floor (the reference's PolyLR)."""
    f32 = np.float32
    frac = f32(1.0) - f32(step) / f32(total_steps)
    return float(np.maximum(f32(base_lr) * np.maximum(frac, f32(0.0)) ** f32(power),
                            f32(min_lr)))


def teacher_ema_decay(step: int, alpha: float = 0.99) -> float:
    """min(1 - 1/(step+1), alpha) — the reference's teacher EMA decay."""
    f32 = np.float32
    return float(np.minimum(f32(1.0) - f32(1.0) / (f32(step) + f32(1.0)), f32(alpha)))
