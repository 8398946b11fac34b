"""Learning-rate schedules as ``step -> lr`` functions, the port of the
reference's ``repro.optim.schedules``.  ``step`` is a Python int or a
0-d integer tensor (an optimizer's ``count``, on its device); the lr is
a 0-d f32 tensor on the step's device, computed in f32 in the
reference's order of operations."""
from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def constant(lr: float):
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=_f32(step).device)


def linear_warmup(lr: float, warmup_steps: int):
    def fn(step):
        s = _f32(step)
        return lr * torch.clamp((s + 1.0) / max(1, warmup_steps), max=1.0)
    return fn


def cosine_decay(lr: float, decay_steps: int, *, min_ratio: float = 0.1):
    def fn(step):
        s = torch.clamp(_f32(step), 0, decay_steps)
        cos = 0.5 * (1.0 + torch.cos(math.pi * s / max(1, decay_steps)))
        return lr * (min_ratio + (1.0 - min_ratio) * cos)
    return fn


def warmup_cosine(lr: float, warmup_steps: int, total_steps: int, *,
                  min_ratio: float = 0.1):
    """Linear warmup then cosine decay to ``min_ratio * lr``: the standard
    LM pre-training schedule."""
    def fn(step):
        s = _f32(step)
        warm = lr * (s + 1.0) / max(1, warmup_steps)
        t = torch.clamp((s - warmup_steps)
                        / max(1, total_steps - warmup_steps), 0.0, 1.0)
        cos = lr * (min_ratio + (1.0 - min_ratio) * 0.5
                    * (1 + torch.cos(math.pi * t)))
        return torch.where(s < warmup_steps, warm, cos)
    return fn


__all__ = ["constant", "linear_warmup", "cosine_decay", "warmup_cosine"]
