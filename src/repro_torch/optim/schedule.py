"""LR schedules (port of ``repro.optim.schedule``): functions of the step
counter, in float32 on the host, as the reference computes them."""
from __future__ import annotations

import numpy as np

__all__ = ["cosine_schedule"]


def cosine_schedule(step, peak_lr: float, warmup: int, total: int, min_ratio=0.1) -> np.float32:
    """Linear warmup to ``peak_lr``, then a cosine down to ``min_ratio *
    peak_lr`` at ``total``: a numpy float32, so a step reads it with no
    device sync."""
    f = np.float32  # every constant in float32, as JAX's weak types make them
    step = f(step)
    warm = f(peak_lr) * step / f(max(warmup, 1))
    t = np.clip((step - f(warmup)) / f(max(total - warmup, 1)), f(0.0), f(1.0))
    cos = f(peak_lr) * (f(min_ratio) + f((1 - min_ratio) * 0.5) * (f(1.0) + np.cos(f(np.pi) * t)))
    return f(warm if step < warmup else cos)
