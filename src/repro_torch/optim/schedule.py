"""LR schedules as pure functions of the step (so a resume needs no LR
state); the counterpart of ``repro.optim.schedule``, in fp32."""

from __future__ import annotations

import math

import torch


def cosine_with_warmup(step, *, peak_lr: float, warmup_steps: int, total_steps: int, final_frac: float = 0.1):
    """Linear warmup to ``peak_lr`` over ``warmup_steps``, then a cosine to
    ``final_frac * peak_lr`` at ``total_steps``; an fp32 scalar tensor."""
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = peak_lr * step / max(warmup_steps, 1)
    prog = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return torch.where(step < warmup_steps, warm, peak_lr * cos)


def linear_warmup_constant(step, *, peak_lr: float, warmup_steps: int):
    step = torch.as_tensor(step, dtype=torch.float32)
    return peak_lr * torch.clamp(step / max(warmup_steps, 1), max=1.0)
