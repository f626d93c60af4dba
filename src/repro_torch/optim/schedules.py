"""Learning-rate schedules (step -> lr, float32 scalar in and out);
counterpart of ``repro/optim/schedules.py``."""
from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step, dtype=torch.float32)


def constant(lr: float):
    def fn(step):
        return torch.full((), lr, dtype=torch.float32, device=_f32(step).device)

    return fn


def cosine_decay(lr: float, decay_steps: int, alpha: float = 0.0):
    def fn(step):
        t = torch.clamp(_f32(step) / decay_steps, max=1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * t))
        return lr * ((1 - alpha) * cos + alpha)

    return fn


def linear_warmup_cosine(lr: float, warmup_steps: int, decay_steps: int, alpha: float = 0.0):
    cos = cosine_decay(lr, max(1, decay_steps - warmup_steps), alpha)

    def fn(step):
        step = _f32(step)
        warm = lr * step / max(1, warmup_steps)
        return torch.where(step < warmup_steps, warm, cos(step - warmup_steps))

    return fn
