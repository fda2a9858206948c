"""LR schedules as functions of the step index (counterpart of
``repro.optim.schedules``), computed in float32 as the reference's are.

``step`` may be a Python int or an integer tensor (then the result
lives on its device); each returns a float32 scalar tensor.
"""
from __future__ import annotations

import math

import torch

__all__ = ["linear_warmup", "cosine_schedule"]


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def linear_warmup(step, warmup_steps: int, peak: float) -> torch.Tensor:
    """``peak * min(1, (step + 1) / max(warmup_steps, 1))``."""
    return peak * torch.clamp((_f32(step) + 1) / max(warmup_steps, 1),
                              max=1.0)


def cosine_schedule(step, warmup_steps: int, total_steps: int, peak: float,
                    floor: float = 0.1) -> torch.Tensor:
    """The linear warm-up, then a cosine from ``peak`` down to ``floor *
    peak`` at ``total_steps``, held there after."""
    s = _f32(step)
    warm = linear_warmup(s, warmup_steps, peak)
    t = torch.clamp((s - warmup_steps) / max(total_steps - warmup_steps, 1),
                    0.0, 1.0)
    cos = peak * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * t)))
    return torch.where(s < warmup_steps, warm, cos)
