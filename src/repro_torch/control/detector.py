"""Hotspot detector: the node-track CUSUM step on tensors.

Port of the part of ``repro.control.detector`` that the batched replay
folds into its window loop: ``DetectorConfig`` and ``node_track_step``.
The node track folds each window's node runqlat histograms into a decayed
histogram and runs a one-sided CUSUM on its Eq. (2) average:

    cusum_t = max(0, cusum_{t-1} + (avg_t - mu_t - slack))

where ``mu`` is a slow EWMA baseline.  A node is flagged when the CUSUM
crosses the drift threshold or its decayed tail quantile crosses an
absolute ceiling; a flag consumes the accumulated drift.  The streaming
detector class, and the config fields only it reads, wait for the
control-plane slice.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import metric


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    decay: float = 0.5        # per-update decay of the accumulated histograms
    baseline_alpha: float = 0.05  # EWMA rate of the drift baseline mu
    slack: float = 8.0        # CUSUM allowance (latency units above baseline)
    drift_threshold: float = 60.0  # cumulative drift (latency units) to flag
    quantile: float = 95.0    # tracked tail quantile
    abs_threshold: float = 400.0   # acute p-quantile ceiling (latency units)
    warmup: int = 2           # updates before flags are allowed


def node_track_step(hist, mu, cusum, steps: int, node_hists, decay, alpha,
                    slack, drift_thr, q, abs_thr, warmup):
    """One node-track CUSUM step over every node row.

    ``hist`` (R, 200), ``mu`` / ``cusum`` (R,), ``node_hists`` (R, 200);
    ``steps`` is the number of earlier updates, a host integer shared by
    every row.  Returns (hist, avg, p_tail, mu, cusum_after_reset,
    cusum_trip, drift_trip, acute_trip, raw_hot, hot); the caller owns the
    ``steps`` increment.
    """
    hist = hist * decay + node_hists
    avg = metric.avg_runqlat(hist)
    p_tail = metric.percentile(hist, q)

    # the first observation seeds the baseline; afterwards it moves slowly
    # so a genuine drift accumulates in the CUSUM before mu absorbs it
    mu = avg if steps == 0 else (1.0 - alpha) * mu + alpha * avg
    cusum = torch.clamp_min(cusum + (avg - mu - slack), 0.0)

    drift_trip = cusum > drift_thr
    acute_trip = p_tail > abs_thr
    raw_hot = drift_trip | acute_trip
    hot = raw_hot if steps >= warmup else torch.zeros_like(raw_hot)

    # a flag consumes the drift; the reset keys on the RAW flag, so drift
    # accumulated during warmup cannot fire at exactly steps == warmup
    cusum_trip = cusum
    cusum = torch.where(raw_hot, 0.0, cusum)
    return (hist, avg, p_tail, mu, cusum, cusum_trip, drift_trip, acute_trip,
            raw_hot, hot)
