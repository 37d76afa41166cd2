"""Baseline schedulers from the paper's evaluation (Section V-D).

Port of ``repro.core.baselines``:

RR  -- Round Robin: cyclic assignment.
HUP -- High Utilization Priority (Eq. 7):
       HUPscore_h = utiliz_cpu * utiliz_mem - intf_h - intf_p
LQP -- Low QPS Priority: the node with the lowest total online QPS.

All honour ICO's feasibility thresholds and divide by each node's own
capacity.  Dtypes follow the JAX package's numpy code: utilization in
float32, HUP's score in float64 (its Eq. 3 term is float64).  With a
``recorder`` attached each emits an ``AdmissionDecision`` holding the
terms its own policy scored on (host copies).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.scheduler import SchedulerConfig


def _projected_utilization(pod, view, cfg: SchedulerConfig):
    cpu = (view.cpu_cur + cfg.w_d * pod.cpu_demand) / view.cpu_sum
    mem = (view.mem_cur + cfg.w_e * pod.mem_demand) / view.mem_sum
    feasible = (cpu <= cfg.cpu_threshold) & (mem <= cfg.mem_threshold)
    return cpu, mem, feasible


def _emit_admission(scheduler, pod, best: int, breakdown: dict) -> None:
    """The baselines' AdmissionDecision; tensors come to the host."""
    from repro_torch.obs import AdmissionDecision

    scheduler.recorder.emit(AdmissionDecision(
        scheduler=scheduler.name, workload=pod.workload, qps=float(pod.qps),
        online=bool(pod.is_online), cpu_demand=float(pod.cpu_demand),
        mem_demand=float(pod.mem_demand), chosen=int(best),
        breakdown={k: v.cpu().numpy() if isinstance(v, torch.Tensor) else v
                   for k, v in breakdown.items()},
    ))


class RoundRobinScheduler:
    name = "RR"

    def __init__(self, config: SchedulerConfig | None = None):
        self.cfg = config or SchedulerConfig()
        self._next = 0
        self.recorder = None

    def select_node(self, pod, view) -> int:
        rotation_start = self._next
        _, _, feasible = _projected_utilization(pod, view, self.cfg)
        feasible = feasible.cpu().numpy()
        n = feasible.shape[0]
        best = -1
        for k in range(n):
            idx = (self._next + k) % n
            if feasible[idx]:
                self._next = (idx + 1) % n
                best = int(idx)
                break
        if self.recorder:
            _emit_admission(self, pod, best, {
                "feasible": feasible, "rotation_start": rotation_start})
        return best


class HUPScheduler:
    """High Utilization Priority -- Eq. (7)."""

    name = "HUP"

    def __init__(self, quantifier, config: SchedulerConfig | None = None):
        self.q = quantifier
        self.cfg = config or SchedulerConfig()
        self.recorder = None

    def select_node(self, pod, view) -> int:
        cpu, mem, feasible = _projected_utilization(pod, view, self.cfg)
        intf_h = self.q.intf_nodes(view.online_hists, view.offline_hists)
        intf_p = self.q.intf_pod(pod.qps, view.features)
        score = cpu * mem - intf_h - intf_p  # Eq. (7)
        score = torch.where(feasible, score, -torch.inf)
        best = int(torch.argmax(score))
        best = best if bool(torch.isfinite(score[best])) else -1
        if self.recorder:
            _emit_admission(self, pod, best, {
                "utiliz_cpu": cpu, "utiliz_mem": mem, "intf_h": intf_h,
                "intf_p": intf_p, "feasible": feasible, "score": score})
        return best


class LQPScheduler:
    """Low QPS Priority -- lowest total online QPS wins."""

    name = "LQP"

    def __init__(self, config: SchedulerConfig | None = None):
        self.cfg = config or SchedulerConfig()
        self.recorder = None

    def select_node(self, pod, view) -> int:
        _, _, feasible = _projected_utilization(pod, view, self.cfg)
        qps = torch.where(feasible, view.online_qps_sum.double(), torch.inf)
        best = int(torch.argmin(qps))
        best = best if bool(torch.isfinite(qps[best])) else -1
        if self.recorder:
            _emit_admission(self, pod, best, {
                "online_qps_sum": qps, "feasible": feasible})
        return best
