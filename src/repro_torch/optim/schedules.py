"""Port of ``src/repro/optim/schedules.py``: LR schedules.

The reference computes in f32 arrays (its python floats and ``jnp.pi``
enter as weak f32), so the port computes in f32 tensors on the step's
device, one rounding per operation as the reference's.
"""
from __future__ import annotations

import math

import torch


def cosine_warmup(step, *, base_lr: float, warmup_steps: int,
                  total_steps: int, min_ratio: float = 0.1, device=None):
    """Linear warmup to ``base_lr``, then cosine decay to ``min_ratio`` of
    it. ``step`` is an int or a tensor; the result is a 0-d f32 tensor on
    ``step``'s device (a tensor's) or ``device`` (an int's)."""
    if isinstance(step, torch.Tensor):
        step = step.to(torch.float32)
    else:
        step = torch.tensor(float(step), dtype=torch.float32, device=device)
    warm = base_lr * torch.clamp((step + 1) / max(warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - warmup_steps)
                       / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * frac))
    return torch.where(step < warmup_steps, warm, base_lr * cos)
