"""LR schedule (paper §6: linear warm-up then cosine decay), the port's copy
of ``repro/optim/schedule.py::warmup_cosine``.  Evaluated on the host in
float32 with the reference's order of operations; returns a Python float."""
from __future__ import annotations

import math

import numpy as np


def warmup_cosine(step, *, base_lr: float = 1e-4, warmup_steps: int = 1000,
                  total_steps: int = 100_000, min_lr: float = 1e-5,
                  init_lr: float = 1e-6) -> float:
    """Ramped linear warm-up from init_lr to base_lr over ``warmup_steps``,
    cosine anneal to min_lr afterwards."""
    f32 = np.float32
    step = f32(step)
    if step < warmup_steps:
        ramp = min(step / f32(max(warmup_steps, 1)), f32(1.0))
        return float(f32(init_lr) + f32(base_lr - init_lr) * ramp)
    t = (step - f32(warmup_steps)) / f32(max(total_steps - warmup_steps, 1))
    t = min(max(t, f32(0.0)), f32(1.0))
    cos = f32(1.0) + np.cos(f32(math.pi) * t)
    return float(f32(min_lr) + f32(0.5 * (base_lr - min_lr)) * cos)
