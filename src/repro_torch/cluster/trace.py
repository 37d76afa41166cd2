"""Alibaba cluster-trace-v2018-shaped QPS generators (a copy of
``repro.cluster.trace``, which imports no JAX).

The paper replays request rates whose shape follows the Alibaba 2018 trace
(diurnal waves + noise + bursts, fluctuating around a target mean).  The
real trace is not available offline, so we synthesize traces with the same
statistical signature: a dominant diurnal component, a weaker half-day
harmonic, AR(1) noise, and occasional bursts.
"""
from __future__ import annotations

import numpy as np

TICKS_PER_DAY = 2880  # 30s ticks


def qps_trace(
    mean_qps: float,
    num_ticks: int,
    seed: int = 0,
    diurnal_amp: float = 0.35,
    harmonic_amp: float = 0.12,
    noise_sigma: float = 0.06,
    burst_prob: float = 0.004,
    burst_amp: float = 0.6,
) -> np.ndarray:
    """Generate a (num_ticks,) QPS series fluctuating around mean_qps."""
    rng = np.random.default_rng(seed)
    t = np.arange(num_ticks)
    phase = rng.uniform(0, 2 * np.pi)
    base = (
        1.0
        + diurnal_amp * np.sin(2 * np.pi * t / TICKS_PER_DAY + phase)
        + harmonic_amp * np.sin(4 * np.pi * t / TICKS_PER_DAY + phase * 1.7)
    )
    # AR(1) noise
    eps = rng.normal(0, noise_sigma, num_ticks)
    ar = np.empty(num_ticks)
    acc = 0.0
    for i in range(num_ticks):
        acc = 0.9 * acc + eps[i]
        ar[i] = acc
    # bursts with exponential decay
    burst = np.zeros(num_ticks)
    idx = np.nonzero(rng.random(num_ticks) < burst_prob)[0]
    for i in idx:
        dur = rng.integers(5, 40)
        end = min(num_ticks, i + dur)
        burst[i:end] += burst_amp * rng.random() * np.exp(
            -np.arange(end - i) / max(dur / 3, 1)
        )
    series = mean_qps * np.clip(base + ar + burst, 0.05, None)
    return series.astype(np.float32)


def poisson_arrivals(rate_per_tick: float, num_ticks: int, seed: int = 0) -> np.ndarray:
    """Pod-arrival tick indices (paper: 'submit a pod after a random time
    interval')."""
    rng = np.random.default_rng(seed)
    ticks = []
    t = 0.0
    while True:
        t += rng.exponential(1.0 / rate_per_tick)
        if t >= num_ticks:
            break
        ticks.append(int(t))
    return np.asarray(ticks, np.int64)
