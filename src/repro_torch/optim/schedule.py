"""LR schedules: the port's copy of ``repro/optim/schedule.py``.  Each
schedule maps a step (an integer tensor, as AdamW's ``step``) to an f32
learning rate, in the JAX functions' f32 arithmetic."""
from __future__ import annotations

import math

import torch


def cosine_schedule(base_lr: float, total_steps: int, min_ratio: float = 0.1):
    def fn(step: torch.Tensor) -> torch.Tensor:
        t = torch.clamp(step.float() / max(total_steps, 1), max=1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * t))
        return base_lr * (min_ratio + (1.0 - min_ratio) * cos)

    return fn


def linear_warmup_cosine(base_lr: float, warmup_steps: int, total_steps: int,
                         min_ratio: float = 0.1):
    cos = cosine_schedule(base_lr, max(total_steps - warmup_steps, 1), min_ratio)

    def fn(step: torch.Tensor) -> torch.Tensor:
        s = step.float()
        warm = base_lr * s / max(warmup_steps, 1)
        return torch.where(s < warmup_steps, warm, cos(step - warmup_steps))

    return fn
