"""ICO scheduler -- paper Algorithm 1 with scoring Eqs. (4)-(6).

    score_h = (1 - utiliz_cpu_h) * (1 - utiliz_mem_h) - intf_h - intf_p      (4)
    utiliz_cpu_h = (cpu_cur_h + w_d * cpu_pod) / cpu_sum_h                    (5)
    utiliz_mem_h = (mem_cur_h + w_e * mem_pod) / mem_sum_h                    (6)

Port of ``repro.core.scheduler``.  Nodes over the thresholds (CPU > 0.70,
MEM > 0.80) are excluded; the best score wins and -1 means no feasible
node.  Scoring runs on the view's device.  Past
``SchedulerConfig.candidate_k`` nodes the top-k prefilter
(``repro_torch.cluster.fleet.topk_candidates``) picks the candidates and
the interference terms run on only those.

``ICOFScheduler`` ("ICO-F") adds the projected node runqlat drift of a
view that ``ForecastService.annotate`` filled to ``intf_h``: the same
projection, trust gate and ``rho_cap`` clamp the mitigation loop prices
relief with.  Without an annotation, or on nodes with no trusted pod, it
scores exactly as ICO.

With a ``recorder`` attached, ``select_node`` emits an
``AdmissionDecision`` with the per-node Eq. (4)-(6) terms, computed on the
host in numpy from the same view as the JAX package computes them.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.interference import INTF_NORM


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    cpu_threshold: float = 0.70
    mem_threshold: float = 0.80
    w_d: float = 1.2  # > 1 per paper (headroom on predicted pod CPU)
    w_e: float = 1.2  # > 1 per paper (headroom on predicted pod MEM)
    # fleets larger than this go through the top-k prefilter; at or below
    # it the exact all-nodes path runs
    candidate_k: int = 64

    def __post_init__(self):
        if not (self.w_d > 1.0 and self.w_e > 1.0):
            raise ValueError("paper requires w_d, w_e > 1.0")
        if self.candidate_k < 1:
            raise ValueError("candidate_k must be >= 1")


def _f32(x: float, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


def _score_nodes(cpu_cur, cpu_sum, mem_cur, mem_sum, intf_h, intf_p,
                 cpu_pod, mem_pod, w_d, w_e, cpu_thr, mem_thr):
    """(best index or -1, scores) -- all float32, as the JAX scorer."""
    utiliz_cpu = (cpu_cur + w_d * cpu_pod) / cpu_sum      # Eq. (5)
    utiliz_mem = (mem_cur + w_e * mem_pod) / mem_sum      # Eq. (6)
    feasible = (utiliz_cpu <= cpu_thr) & (utiliz_mem <= mem_thr)
    score = (1.0 - utiliz_cpu) * (1.0 - utiliz_mem) - intf_h - intf_p  # (4)
    score = torch.where(feasible, score, -torch.inf)
    best = torch.argmax(score)
    ok = torch.isfinite(score[best])
    return torch.where(ok, best, -1), score


class ICOScheduler:
    """Interference-aware Container Orchestration scheduler (Algorithm 1)."""

    name = "ICO"

    def __init__(self, quantifier, config: SchedulerConfig | None = None):
        self.q = quantifier
        self.cfg = config or SchedulerConfig()
        self.recorder = None  # optional TraceRecorder: AdmissionDecision
                              # events with the Eq. (4)-(6) breakdown

    def _interference(self, pod, view):
        """(intf_h, intf_p) for Eq. (4) -- the hook ICO-F augments."""
        intf_h = self.q.intf_nodes(view.online_hists, view.offline_hists)
        intf_p = self.q.intf_pod(pod.qps, view.features)
        return intf_h, intf_p

    def _forecast_term(self, view):
        """Per-node forecast addend to ``intf_h`` (None for plain ICO)."""
        return None

    def _score(self, pod, view):
        if view.num_nodes > self.cfg.candidate_k:
            return self._score_topk(pod, view)
        return self._score_exact(pod, view)

    def _score_exact(self, pod, view):
        intf_h, intf_p = self._interference(pod, view)
        dev = view.cpu_cur.device
        return _score_nodes(
            view.cpu_cur.float(), view.cpu_sum.float(),
            view.mem_cur.float(), view.mem_sum.float(),
            intf_h.float(), intf_p.float(),
            _f32(pod.cpu_demand, dev), _f32(pod.mem_demand, dev),
            self.cfg.w_d, self.cfg.w_e,
            self.cfg.cpu_threshold, self.cfg.mem_threshold,
        )

    def _score_topk(self, pod, view):
        """Sub-linear admission: the prefilter over all N nodes picks
        candidate_k candidates, Eq. (4) runs on those.  Returns the best
        global index and a full-length score tensor (-inf outside the
        candidate set)."""
        from repro_torch.cluster.fleet import topk_candidates
        cfg = self.cfg
        dev = view.cpu_cur.device
        idx, _pre = topk_candidates(
            view.cpu_cur.float(), view.cpu_sum.float(),
            view.mem_cur.float(), view.mem_sum.float(),
            _f32(cfg.w_d * pod.cpu_demand, dev),
            _f32(cfg.w_e * pod.mem_demand, dev),
            cfg.cpu_threshold, cfg.mem_threshold, cfg.candidate_k,
        )
        best_local, score_k = self._score_exact(pod, view.take(idx))
        score = torch.full((view.num_nodes,), -torch.inf,
                           dtype=torch.float32, device=dev)
        score[idx] = score_k
        best = int(best_local)
        return (-1 if best < 0 else int(idx[best])), score

    def select_node(self, pod, view) -> int:
        """Algorithm 1: the selected node index, or -1 (queue the pod).

        pod: object with .qps, .cpu_demand, .mem_demand.
        view: ``repro_torch.cluster.view.ClusterView``.
        """
        best, score = self._score(pod, view)
        if self.recorder:
            self.recorder.emit(self._admission_event(
                pod, view, score.cpu().numpy(), int(best)))
        return int(best)

    def scores(self, pod, view) -> torch.Tensor:
        _, score = self._score(pod, view)
        return score

    def _admission_event(self, pod, view, score: np.ndarray, best: int):
        """The AdmissionDecision with the Eq. (4)-(6) term breakdown over
        every node of ``view``, recomputed in numpy from the view's host
        copies (so ``explain`` reproduces the score from the trace alone)."""
        from repro_torch.obs import AdmissionDecision

        cfg = self.cfg
        cpu_sum = view.cpu_sum.cpu().numpy().astype(np.float64)
        mem_sum = view.mem_sum.cpu().numpy().astype(np.float64)
        utiliz_cpu = (view.cpu_cur.cpu().numpy()
                      + cfg.w_d * pod.cpu_demand) / cpu_sum
        utiliz_mem = (view.mem_cur.cpu().numpy()
                      + cfg.w_e * pod.mem_demand) / mem_sum
        feasible = ((utiliz_cpu <= cfg.cpu_threshold)
                    & (utiliz_mem <= cfg.mem_threshold))
        intf_h, intf_p = self._interference(pod, view)
        breakdown = {
            "utiliz_cpu": utiliz_cpu,
            "utiliz_mem": utiliz_mem,
            "intf_h": intf_h.cpu().numpy(),
            "intf_p": intf_p.cpu().numpy(),
            "feasible": feasible,
            "score": score,
        }
        fterm = self._forecast_term(view)
        if fterm is not None:
            # intf_h above already holds ICO-F's addend: split it back out
            # so the stored terms decompose the score once
            breakdown["forecast_term"] = fterm.cpu().numpy()
            breakdown["intf_h"] = (breakdown["intf_h"]
                                   - breakdown["forecast_term"])
        return AdmissionDecision(
            scheduler=self.name, workload=pod.workload, qps=float(pod.qps),
            online=bool(pod.is_online), cpu_demand=float(pod.cpu_demand),
            mem_demand=float(pod.mem_demand), chosen=best,
            breakdown=breakdown,
        )


class ICOFScheduler(ICOScheduler):
    """ICO-F: Algorithm 1 scoring on projected contention.

    ``intf_h`` gains ``w_f * forecast_drift / OVERFLOW_EDGE`` (float64, as
    JAX's numpy adds it to the float32 term before the float32 scorer):
    the node runqlat increase the shared projection expects ``horizon``
    windows ahead.  A view without an annotation gives ``forecast_drift()
    is None`` and the score is ICO's term for term.
    """

    name = "ICO-F"

    def __init__(self, quantifier, config: SchedulerConfig | None = None,
                 w_f: float = 1.0):
        super().__init__(quantifier, config)
        if not w_f > 0.0:
            raise ValueError("w_f must be > 0 (use ICOScheduler to disable)")
        self.w_f = w_f

    def _interference(self, pod, view):
        intf_h, intf_p = super()._interference(pod, view)
        fterm = self._forecast_term(view)
        if fterm is not None:
            intf_h = intf_h.double() + fterm
        return intf_h, intf_p

    def _forecast_term(self, view):
        drift = view.forecast_drift()
        if drift is None:
            return None
        return self.w_f * INTF_NORM * drift
