"""LR schedules: functions of the step counter — port of
``repro.optim.schedule``.

``step`` is a 0-d integer tensor (on the device that trains), so the
learning rate is computed where it is used and a captured CUDA graph
recomputes it from the live counter at every replay; a Python int works
too.  The arithmetic is the reference's, in float32.
"""

from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def cosine_schedule(step, *, base_lr: float, total_steps: int,
                    final_frac: float = 0.1) -> torch.Tensor:
    t = torch.clamp(_f32(step) / max(total_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * t))
    return base_lr * (final_frac + (1 - final_frac) * cos)


def linear_warmup_cosine(step, *, base_lr: float, warmup_steps: int,
                         total_steps: int, final_frac: float = 0.1) -> torch.Tensor:
    step = torch.as_tensor(step)
    warm = base_lr * (_f32(step) + 1) / max(warmup_steps, 1)
    cos = cosine_schedule(step - warmup_steps, base_lr=base_lr,
                          total_steps=max(total_steps - warmup_steps, 1),
                          final_frac=final_frac)
    return torch.where(step < warmup_steps, warm, cos)
