"""Learning-rate schedules (`repro/optim/schedules.py`). Each returns
`lr_fn(step) -> float`, computed in float32 as the reference computes it,
so the optimizers see the same learning rate."""
from __future__ import annotations

import numpy as np

_F = np.float32


def constant_lr(lr: float):
    value = float(_F(lr))
    return lambda step: value


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  floor: float = 0.0):
    def fn(step):
        step = _F(step)
        if step < warmup_steps:
            return float(_F(peak_lr) * step / _F(max(warmup_steps, 1)))
        t = (step - _F(warmup_steps)) / _F(max(total_steps - warmup_steps, 1))
        t = np.clip(t, _F(0.0), _F(1.0))
        cos = _F(floor) + _F(peak_lr - floor) * _F(0.5) * (_F(1) + np.cos(_F(np.pi) * t))
        return float(cos)
    return fn


def warmup_linear_scaled(base_lr: float, n_processes: int, warmup_steps: int):
    """Paper setup: peak LR scaled with the global process count, linear
    warm-up (the training launcher's schedule)."""
    peak = base_lr * n_processes

    def fn(step):
        step = _F(step)
        if step < warmup_steps:
            return float(_F(peak) * (step + _F(1)) / _F(warmup_steps))
        return float(_F(peak))
    return fn
