"""Learning-rate schedules (pure functions of the step counter), as f32
0-d tensors: the port of ``src/repro/optim/schedules.py``, whose
arithmetic they repeat in f32."""
from __future__ import annotations

import math

import torch


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def linear_warmup(step, warmup: int, peak: float):
    s = _step(step)
    return peak * torch.clamp_max((s + 1.0) / max(warmup, 1), 1.0)


def cosine_schedule(step, warmup: int, total: int, peak: float,
                    floor: float = 0.1):
    s = _step(step)
    warm = peak * torch.clamp_max((s + 1.0) / max(warmup, 1), 1.0)
    frac = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac))
    return torch.where(s < warmup, warm, peak * cos)
