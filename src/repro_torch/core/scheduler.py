"""ICO scheduler -- paper Algorithm 1 with scoring Eqs. (4)-(6).

    score_h = (1 - utiliz_cpu_h) * (1 - utiliz_mem_h) - intf_h - intf_p      (4)
    utiliz_cpu_h = (cpu_cur_h + w_d * cpu_pod) / cpu_sum_h                    (5)
    utiliz_mem_h = (mem_cur_h + w_e * mem_pod) / mem_sum_h                    (6)

Port of ``repro.core.scheduler`` (ICO; ICO-F waits for the control-plane
slice).  Nodes over the thresholds (CPU > 0.70, MEM > 0.80) are excluded;
the best score wins and -1 means no feasible node.  Scoring runs on the
view's device.  Past ``SchedulerConfig.candidate_k`` nodes the top-k
prefilter (``repro_torch.cluster.fleet.topk_candidates``) picks the
candidates and the interference terms run on only those.
"""
from __future__ import annotations

import dataclasses

import torch


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

    def _interference(self, pod, view):
        """(intf_h, intf_p) for Eq. (4)."""
        intf_h = self.q.intf_nodes(view.online_hists, view.offline_hists)
        intf_p = self.q.intf_pod(pod.qps, view.features)
        return intf_h, intf_p

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
        best, _ = self._score(pod, view)
        return int(best)

    def scores(self, pod, view) -> torch.Tensor:
        _, score = self._score(pod, view)
        return score
