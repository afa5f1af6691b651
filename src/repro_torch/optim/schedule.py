"""Learning-rate schedules: pure functions of the step.

The port's twin of the JAX package's ``optim/schedule.py``.  Both take the
optimizer's step counter, a 0-d tensor on the device, and return a 0-d
float32 tensor on the same device: nothing is read to the host.
"""

from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, warmup: int, total: int, floor: float = 0.1):
    """Linear warm-up over ``warmup`` steps, then a cosine from 1 down to
    ``floor`` at ``total``."""
    step = step.float()
    warm = torch.clamp(step / max(warmup, 1), max=1.0)
    frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac))
    return warm * cos


def constant(step, **_):
    return torch.ones_like(step, dtype=torch.float32)
