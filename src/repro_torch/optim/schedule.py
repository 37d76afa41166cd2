"""Learning-rate schedules (warmup + cosine decay, constant, rsqrt).

Port of ``repro.optim.schedule``: the same float32 arithmetic, returned as
a Python float (the float32 value)."""
from __future__ import annotations

import math

import torch


def lr_schedule(step, *, warmup: int = 200, total: int = 10_000,
                kind: str = "cosine", min_frac: float = 0.1) -> float:
    """Returns a multiplier in [min_frac, 1] (0 at step 0 of a warmup)."""
    f32 = torch.float32
    step = torch.as_tensor(step, dtype=f32)
    w = torch.clamp(step / max(warmup, 1), max=1.0)
    if kind == "constant":
        decay = torch.ones((), dtype=f32)
    elif kind == "rsqrt":
        decay = torch.sqrt(torch.tensor(max(warmup, 1.0), dtype=f32)
                           / torch.clamp(step, min=warmup))
    else:  # cosine
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        decay = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi
                                                                 * frac))
    return float(w * decay)
