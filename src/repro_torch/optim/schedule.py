"""Learning-rate schedules, ported from ``repro/optim/schedule.py``: each
maps the optimizer's step, a 0-dim int tensor on the device, to a 0-dim f32
learning rate on the same device, so the host never waits on the step."""

from __future__ import annotations

import math
from typing import Callable

import torch

__all__ = ["warmup_cosine", "constant"]

Schedule = Callable[[torch.Tensor], torch.Tensor]


def warmup_cosine(peak: float, warmup: int, total: int, floor: float = 0.1) -> Schedule:
    """Linear warm-up to ``peak`` over ``warmup`` steps, then a cosine decay
    to ``floor * peak`` at ``total``."""
    def lr(step: torch.Tensor) -> torch.Tensor:
        s = step.float()
        warm = peak * s / max(warmup, 1)
        frac = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac)))
        return torch.where(s < warmup, warm, cos)
    return lr


def constant(value: float) -> Schedule:
    def lr(step: torch.Tensor) -> torch.Tensor:
        return torch.full((), value, dtype=torch.float32, device=step.device)
    return lr
