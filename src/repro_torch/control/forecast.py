"""Seasonal QPS forecaster: the moment update on tensors.

Port of the part of ``repro.control.forecast`` that the batched replay
folds into its window loop: ``ForecastConfig``, the harmonic features and
``_forecast_update``.  Every pod keeps a decayed least-squares regression
of its window-mean QPS onto diurnal harmonics

    x(t) = [1, sin wt, cos wt, sin 2wt, cos 2wt],   w = 2*pi / TICKS_PER_DAY

with moments A = sum decay^k x x^T and b = sum decay^k x y.  The update
scores the previous fit at time t, then folds in the observation.  The
forecast service and its trust gate, and the config fields only they
read, wait for the control-plane slice.
"""
from __future__ import annotations

import dataclasses
import math

import torch

NUM_FEATURES = 5  # [1, sin wt, cos wt, sin 2wt, cos 2wt]
TICKS_PER_DAY = 2880.0
_OMEGA = 2.0 * math.pi / TICKS_PER_DAY


@dataclasses.dataclass(frozen=True)
class ForecastConfig:
    decay: float = 0.995      # per-window decay of the regression moments
    ridge: float = 1.0        # Tikhonov term on the normal-equation solve
    err_alpha: float = 0.3    # EWMA rate of the one-step relative error
    qps_floor: float = 25.0   # rel-error denominator floor (QPS units)


def _features(t: torch.Tensor) -> torch.Tensor:
    """(..., F) harmonic features of a float32 time tensor."""
    wt = _OMEGA * t
    return torch.stack([torch.ones_like(wt), torch.sin(wt), torch.cos(wt),
                        torch.sin(2.0 * wt), torch.cos(2.0 * wt)], dim=-1)


def _solve(A: torch.Tensor, b: torch.Tensor, ridge: float) -> torch.Tensor:
    """Batched ridge solve of (A + ridge I) w = b.  ``solve_ex`` does not
    check the factorisation on the host, so the card is never synchronised;
    A + ridge I is positive definite for ridge > 0."""
    eye = torch.eye(NUM_FEATURES, dtype=A.dtype, device=A.device)
    return torch.linalg.solve_ex(A + ridge * eye, b[..., None]).result[..., 0]


def _forecast_update(A, b, err, count, t, y, active, decay, ridge, alpha,
                     qps_floor):
    """Score the previous fit at time t, then fold in the new observation.

    A (R, S, F, F), b (R, S, F), err / count (R, S); ``t`` a 0-d float32
    tensor; y (R, S) window-mean QPS, active (R, S) bool.  Returns the new
    state plus the one-step prediction the old fit made for this window.
    """
    x = _features(t)                                   # (F,)
    pred = torch.clamp_min((_solve(A, b, ridge) * x).sum(-1), 0.0)
    rel = (pred - y).abs() / torch.clamp_min(y, qps_floor)
    scored = active & (count > 0)
    err = torch.where(scored, (1.0 - alpha) * err + alpha * rel, err)
    xx = x[:, None] * x[None, :]
    A = torch.where(active[..., None, None], decay * A + xx, A)
    b = torch.where(active[..., None], decay * b + x * y[..., None], b)
    count = torch.where(active, count + 1, count)
    return A, b, err, count, pred
