"""LR schedules (port of ``repro.optim.schedule``): pure functions of
the step counter, computed in float32 as the reference computes them.

``step`` may be a Python number or a tensor (the optimizer's on-device
counter); the result is a 0-d float32 tensor on the step's device."""
from __future__ import annotations

import math

import torch

__all__ = ["cosine_schedule", "linear_schedule"]


def _step_f32(step) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step.to(torch.float32)
    return torch.tensor(step, dtype=torch.float32)


def _warm_and_t(step, peak_lr: float, warmup: int, total: int):
    s = _step_f32(step)
    warm = peak_lr * torch.clamp(s / max(warmup, 1), max=1.0)
    t = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    return s, warm, t


def cosine_schedule(step, *, peak_lr: float, warmup: int = 100,
                    total: int = 10_000, floor: float = 0.1):
    """Linear warmup to ``peak_lr``, then a cosine down to ``floor *
    peak_lr`` at ``total``."""
    s, warm, t = _warm_and_t(step, peak_lr, warmup, total)
    cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * t))
    return torch.where(s < warmup, warm, peak_lr * cos)


def linear_schedule(step, *, peak_lr: float, warmup: int = 100,
                    total: int = 10_000):
    """Linear warmup to ``peak_lr``, then linear decay to 0 at
    ``total``."""
    s, warm, t = _warm_and_t(step, peak_lr, warmup, total)
    return torch.where(s < warmup, warm, peak_lr * (1 - t))
