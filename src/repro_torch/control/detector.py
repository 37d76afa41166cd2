"""Streaming hotspot detector over per-node, per-slot runqlat telemetry.

Port of ``repro.control.detector``.  Every window the detector folds the
(node, slot) 200-bin runqlat histograms into exponentially decayed
histograms, on the detector's device, at two granularities:

*Node track* -- the slot histograms summed per node feed a one-sided CUSUM
on the decayed Eq. (2) average:

    cusum_t = max(0, cusum_{t-1} + (avg_t - mu_t - slack))

where ``mu`` is a slow EWMA baseline.  A node is flagged when the CUSUM
crosses the drift threshold or its decayed tail quantile crosses an
absolute ceiling; a flag consumes the accumulated drift (on the raw flag,
so drift accumulated during warmup cannot fire at ``steps == warmup``).
``node_track_step`` is this step alone; the batched replay folds it into
its window loop.

*Slot track* -- each slot keeps its own decayed histogram and a
recency-weighted score of the positive increments of its average:

    score_t = decay * score_{t-1} + max(0, s_avg_t - s_avg_{t-1})

so the pod that started a drift (an arrival jumps its slot's average from
zero) outranks slots that merely rose with it.  ``hot_slots`` names the
drifted slot of each flagged node; below ``attribution_floor`` it names
none rather than an argmax of noise.  The ControlLoop clears a slot's track
when its tenant changes (``clear_slots``).

*Forecast track* -- ``update`` takes an optional projected node runqlat;
a second CUSUM of the predicted exceedance raises *proactive* flags.
Without a forecast the input is JAX's -1e9 sentinel, so that accumulator
stays pinned at zero.  (The forecaster itself comes with a later slice.)

The whole update is one batch of tensor operations over all N nodes and S
slots; its outputs reach the host in one copy.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import metric
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    decay: float = 0.5        # per-update decay of the accumulated histograms
    baseline_alpha: float = 0.05  # EWMA rate of the drift baseline mu
    slack: float = 8.0        # CUSUM allowance (latency units above baseline)
    drift_threshold: float = 60.0  # cumulative drift (latency units) to flag
    quantile: float = 95.0    # tracked tail quantile
    abs_threshold: float = 400.0   # acute p-quantile ceiling (latency units)
    warmup: int = 2           # updates before flags are allowed
    proactive_threshold: float = 60.0  # forecast-CUSUM level for a
                                       # proactive flag
    attribution_floor: float = 5.0     # min slot score to name a culprit


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


def _detector_update(hist, mu, cusum, f_cusum, slot_hist, slot_prev,
                     slot_score, steps: int, slot_hists, forecast_avg, decay,
                     alpha, slack, drift_thr, pro_thr, q, abs_thr, warmup):
    """One detector step for all nodes and slots at once.

    hist (N, 200), mu / cusum / f_cusum (N,), slot_hist (N, S, 200),
    slot_prev / slot_score (N, S), ``steps`` a host integer; slot_hists
    (N, S, 200) this window's per-slot counts; forecast_avg (N,) projected
    node runqlat (-1e9 where there is none).  Returns the new state, the
    hotspot and proactive masks and a diagnostics dict, all tensors.
    """
    node_hists = slot_hists.sum(1)
    (hist, avg, p_tail, mu, cusum, cusum_trip, drift_trip, acute_trip,
     raw_hot, hot) = node_track_step(hist, mu, cusum, steps, node_hists,
                                     decay, alpha, slack, drift_thr, q,
                                     abs_thr, warmup)
    armed = steps >= warmup

    # forecast channel: CUSUM of the predicted exceedance over the same
    # observed baseline, corroborated by the observed average; a reactive
    # flag outranks a proactive one and either consumes both accumulators
    f_cusum = torch.clamp_min(f_cusum + (forecast_avg - mu - slack), 0.0)
    raw_pro = (f_cusum > pro_thr) & (avg > mu + slack)
    proactive = (raw_pro & ~raw_hot) if armed else torch.zeros_like(raw_pro)
    f_cusum_trip = f_cusum
    f_cusum = torch.where(raw_hot | raw_pro, 0.0, f_cusum)

    # slot track: a vacated slot's decayed average is invariant under decay
    # so it stops scoring; an arrival scores its full jump
    slot_hist = slot_hist * decay + slot_hists
    s_avg = metric.avg_runqlat(slot_hist)
    slot_score = decay * slot_score + torch.clamp_min(s_avg - slot_prev, 0.0)
    slot_prev = s_avg

    off = torch.zeros_like(drift_trip)
    diag = {"avg": avg, "p_tail": p_tail, "mu": mu, "cusum": cusum,
            "f_cusum": f_cusum, "slot_avg": s_avg, "slot_score": slot_score,
            "cusum_trip": cusum_trip, "f_cusum_trip": f_cusum_trip,
            "drift_hot": drift_trip if armed else off,
            "acute_hot": acute_trip if armed else off}
    return (hist, mu, cusum, f_cusum, slot_hist, slot_prev, slot_score,
            steps + 1, hot, proactive, diag)


def to_host(tensors: dict) -> dict:
    """Copy a dict of float32 / bool tensors to numpy in one transfer."""
    flat = torch.cat([t.reshape(-1).float() for t in tensors.values()])
    flat = flat.cpu().numpy()
    out, i = {}, 0
    for k, t in tensors.items():
        a = flat[i:i + t.numel()].reshape(t.shape)
        out[k] = a.astype(bool) if t.dtype == torch.bool else a
        i += t.numel()
    return out


class StreamingDetector:
    """Host-side wrapper owning the detector state for one cluster; the
    state lives on ``device`` (``None`` -> the CUDA card)."""

    def __init__(self, num_nodes: int, config: DetectorConfig | None = None,
                 *, device=None):
        self.cfg = config or DetectorConfig()
        self.n = num_nodes
        self.device = resolve_device(device)
        self.reset()

    def _zeros(self, *shape) -> torch.Tensor:
        return torch.zeros(shape, dtype=torch.float32, device=self.device)

    def reset(self) -> None:
        self.hist = self._zeros(self.n, metric.NUM_BINS)
        self.mu = self._zeros(self.n)
        self.cusum = self._zeros(self.n)
        self.f_cusum = self._zeros(self.n)
        self.steps = 0
        # the slot track is shaped by the first update (S is a property of
        # the telemetry, not of the cluster size)
        self.num_slots: int | None = None
        self.slot_hist = None
        self.slot_prev = None
        self.slot_score = None
        self.slot_scores: np.ndarray | None = None  # (N, S) after update()
        self.last_hot: np.ndarray | None = None
        self.last_proactive: np.ndarray | None = None
        self.last_diag: dict | None = None

    def _ensure_slots(self, num_slots: int) -> None:
        if self.num_slots == num_slots:
            return
        self.num_slots = num_slots
        self.slot_hist = self._zeros(self.n, num_slots, metric.NUM_BINS)
        self.slot_prev = self._zeros(self.n, num_slots)
        self.slot_score = self._zeros(self.n, num_slots)

    def clear_slots(self, nodes, slots) -> None:
        """Forget the attribution track of (node, slot) pairs whose tenant
        changed, so a reused slot never inherits its predecessor's score."""
        if self.slot_hist is None:
            return
        nodes = np.asarray(nodes, np.int64).ravel()
        slots = np.asarray(slots, np.int64).ravel()
        if nodes.size == 0:
            return
        idx = (torch.as_tensor(nodes, device=self.device),
               torch.as_tensor(slots, device=self.device))
        self.slot_hist[idx] = 0.0
        self.slot_prev[idx] = 0.0
        self.slot_score[idx] = 0.0
        if self.slot_scores is not None:
            self.slot_scores = self.slot_scores.copy()
            self.slot_scores[nodes, slots] = 0.0

    def update(self, hists, forecast_avg=None) -> np.ndarray:
        """Feed one window of runqlat histograms; returns the (N,) hotspot
        mask.

        hists: (N, S, 200) per-slot counts or (N, 200) node counts (one
        slot).  forecast_avg: optional (N,) projected node runqlat; without
        it the forecast CUSUM stays pinned at zero.
        """
        c = self.cfg
        hists = torch.as_tensor(hists, dtype=torch.float32,
                                device=self.device)
        if hists.dim() == 2:
            hists = hists[:, None, :]
        self._ensure_slots(hists.shape[1])
        if forecast_avg is None:
            forecast_avg = torch.full((self.n,), -1e9, device=self.device)
        else:
            forecast_avg = torch.as_tensor(forecast_avg, dtype=torch.float32,
                                           device=self.device)
        (self.hist, self.mu, self.cusum, self.f_cusum, self.slot_hist,
         self.slot_prev, self.slot_score, self.steps, hot, proactive,
         diag) = _detector_update(
            self.hist, self.mu, self.cusum, self.f_cusum, self.slot_hist,
            self.slot_prev, self.slot_score, self.steps, hists, forecast_avg,
            c.decay, c.baseline_alpha, c.slack, c.drift_threshold,
            c.proactive_threshold, c.quantile, c.abs_threshold, c.warmup,
        )
        host = to_host({**diag, "hot": hot, "proactive": proactive})
        self.last_hot = host.pop("hot")
        self.last_proactive = host.pop("proactive")
        self.last_diag = host
        self.slot_scores = host["slot_score"]
        return self.last_hot

    def hot_slots(self) -> dict[int, int]:
        """Attribution of the last update: flagged node -> drifted slot,
        omitting nodes whose best score is under ``attribution_floor``."""
        if self.last_hot is None or self.slot_scores is None:
            return {}
        floor = self.cfg.attribution_floor
        out: dict[int, int] = {}
        for n in np.nonzero(self.last_hot)[0]:
            s = int(np.argmax(self.slot_scores[n]))
            if self.slot_scores[n, s] >= floor:
                out[int(n)] = s
        return out

    def attribution(self) -> np.ndarray | None:
        """Slot scores with sub-floor entries zeroed, for the policy (a
        zero means "no attribution": the policy falls back to its
        pressure/QPS heuristics)."""
        if self.slot_scores is None:
            return None
        floor = self.cfg.attribution_floor
        return np.where(self.slot_scores >= floor, self.slot_scores, 0.0)
