"""LR schedules (the reference's ``optim/schedule.py``)."""
from __future__ import annotations

import math

import torch


def cosine_schedule(peak_lr: float, warmup_steps: int, total_steps: int,
                    final_frac: float = 0.1):
    """Linear warmup then cosine decay to ``final_frac * peak_lr``; the
    returned ``lr(step)`` takes a 0-dim integer tensor and returns a
    float32 one on its device."""

    def lr(step: torch.Tensor) -> torch.Tensor:
        s = step.to(torch.float32)
        warm_n = torch.full_like(s, float(max(warmup_steps, 1)))
        span = torch.full_like(s, float(max(total_steps - warmup_steps, 1)))
        warm = peak_lr * torch.clamp(s / warm_n, max=1.0)
        t = torch.clamp((s - warmup_steps) / span, 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi
                                                                  * t))
        return torch.where(s < warmup_steps, warm, peak_lr * cos)

    return lr
