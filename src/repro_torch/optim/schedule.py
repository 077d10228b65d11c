"""LR schedules (the JAX package's ``repro/optim/schedule.py``)."""
from __future__ import annotations

import math

import torch


def cosine_with_warmup(base_lr: float, warmup: int, total: int, min_ratio: float = 0.1):
    """Linear warmup to ``base_lr`` over ``warmup`` steps, then a cosine to
    ``min_ratio * base_lr`` at ``total``; ``lr(step)`` is an f32 scalar
    tensor on the step's device."""
    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = base_lr * torch.clamp_max(step / max(warmup, 1), 1.0)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * frac))
        return torch.where(step < warmup, warm, base_lr * cos)

    return lr
