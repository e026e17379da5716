"""LR schedules as functions of the step, the port of
``repro.optim.schedules``: ``step`` is a tensor (an ``OptState.step``) or
an int, and the schedule a float32 tensor on its device, as the
reference's."""
from __future__ import annotations

import math

import torch


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def linear_warmup(step, base_lr: float, warmup_steps: int) -> torch.Tensor:
    frac = torch.clamp(_step(step) / max(warmup_steps, 1), max=1.0)
    return base_lr * frac


def cosine_schedule(step, base_lr: float, warmup_steps: int,
                    total_steps: int, min_frac: float = 0.1) -> torch.Tensor:
    s = _step(step)
    warm = torch.clamp(s / max(warmup_steps, 1), max=1.0)
    prog = torch.clamp((s - warmup_steps) / max(total_steps - warmup_steps, 1),
                       0.0, 1.0)
    cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return base_lr * warm * cos
