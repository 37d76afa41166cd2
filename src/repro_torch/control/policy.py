"""Mitigation policy: rank candidate actions per hotspot by predicted
runqlat reduction under a per-invocation budget.

Port of ``repro.control.policy``.  For every flagged node the policy
enumerates one candidate of each action type (evict / throttle an offline
offender, migrate / scale out an online victim) and estimates the runqlat
reduction each buys:

  * source-side relief from the simulator's M/G/1-PS delay curve --
    removing c cores of burst-weighted pressure from a node at pressure
    rho is worth delay(rho) - delay(rho - c/cores);
  * pod-side effects from the Interference Quantification Module: the
    Random Forest behind Eq. (3) predicts, on the view's device, the
    runqlat an online pod would see on every node at once, and migration
    destinations are the argmin of that prediction among the feasible
    (Eqs. 5-6, also on the device), non-hot nodes with a free slot.

Victims are attribution-first (the detector's per-slot drift scores), with
the node-level heuristics (cores x burst for offline, QPS for online) as
tie-breakers.  Candidates are scored by ``correction[kind] *
predicted_reduction - cost_weight * cost`` and applied greedily under the
budget.  The relief arithmetic is a few scalar float64 evaluations per
candidate on the host, as in the JAX package, with the per-node delay
parameters rebuilt from the machine classes' Python floats.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.cluster.state import RHO_EPS, RUNQLAT_BASE, RUNQLAT_SCALE, S_ON
from repro_torch.cluster.workloads import ONLINE_PROFILES
from repro_torch.control.actions import (
    Action,
    EvictOffline,
    MigrateOnline,
    ScaleOut,
    VerticalResize,
)
from repro_torch.core import metric


@dataclasses.dataclass(frozen=True)
class PolicyConfig:
    budget: float = 16.0          # cost units spendable per invocation
    cost_weight: float = 1.0      # latency units one cost unit must buy
    evict_cost_per_core: float = 0.8
    migrate_cost: float = 3.0
    scale_out_cost: float = 5.0
    resize_cost: float = 0.5
    throttle_frac: float = 0.5    # vertical resize shrinks cores to this
    min_offline_cores: float = 2.0  # never throttle a job below this
    cpu_threshold: float = 0.70   # destination feasibility: the
    mem_threshold: float = 0.80   # scheduler's Eq. (5)/(6) cutoffs
    # destination demand is not headroom-inflated (w_d = w_e = 1): runtime
    # rebalancing moves load the cluster already carries
    w_d: float = 1.0
    w_e: float = 1.0
    max_actions_per_node: int = 2
    min_scale_qps: float = 150.0  # don't split a service below this
    migrate_margin: float = 15.0  # min predicted runqlat gap (src - dst)
                                  # before moving a pod is worth the churn
    transfer_latency_weight: float = 8.0  # latency units per unit of
                                  # topology cost factor above same-rack
    proactive_cost_scale: float = 0.6  # discount of ahead-of-time actions
    destination_actions: bool = True   # offer migrate / scale-out at all
                                       # (the RR/HUP profiles turn it off)


def node_delay_curve(rho, base=None, scale=None, knee=None) -> np.ndarray:
    """The simulator's delay curve as the relief model, always float64.

    ``base`` / ``scale`` / ``knee`` are scalars or (N,) float64 arrays
    (``view_delay_params``) and default to the homogeneous constants.
    """
    base = RUNQLAT_BASE if base is None else base
    scale = RUNQLAT_SCALE if scale is None else scale
    knee = RHO_EPS if knee is None else knee
    rho = np.asarray(rho, np.float64)
    return base + scale * rho**2 / np.maximum(1.0 - rho, knee)


def view_delay_params(view):
    """(base, scale, knee) per-node float64 arrays from a view, or the
    homogeneous constants for a view built without them."""
    if getattr(view, "delay_base", None) is None:
        return RUNQLAT_BASE, RUNQLAT_SCALE, RHO_EPS
    return (np.asarray(view.delay_base, np.float64),
            np.asarray(view.delay_scale, np.float64),
            np.asarray(view.rho_knee, np.float64))


def _node_delay_params(view, node: int):
    """One node's (base, scale, knee) as Python floats."""
    base, scale, knee = view_delay_params(view)
    if np.ndim(base) == 0:
        return float(base), float(scale), float(knee)
    return float(base[node]), float(scale[node]), float(knee[node])


class MitigationPolicy:
    """Plans (does not apply) mitigation actions for flagged hotspots."""

    def __init__(self, quantifier, config: PolicyConfig | None = None):
        self.q = quantifier
        self.cfg = config or PolicyConfig()

    # -------- helpers --------

    def _pressure(self, cluster, view, node: int, pods: list[dict]) -> float:
        """Burst-weighted run-queue pressure of a node (peak, not average)."""
        rho = float(view.cpu_cur[node] / view.cpu_sum[node])
        extra = sum(p["cores"] * (p["burst"] - 1.0) for p in pods
                    if p["kind"] == "off")
        return rho + extra / float(view.cpu_sum[node])

    def _relief(self, rho: float, dcores: float, cores: float,
                params=None) -> float:
        """Delay reduction from removing ``dcores`` of pressure at ``rho``;
        ``params`` is one node's (base, scale, knee)."""
        b, s, k = params or (RUNQLAT_BASE, RUNQLAT_SCALE, RHO_EPS)
        return float(node_delay_curve(rho, b, s, k)
                     - node_delay_curve(rho - dcores / cores, b, s, k))

    def _destinations(self, view, hot: np.ndarray, cpu_pod: float,
                      mem_pod: float, free_mask: torch.Tensor) -> np.ndarray:
        """Feasible, non-hot destination nodes with a free online slot."""
        cfg = self.cfg
        cpu_ok = ((view.cpu_cur + cfg.w_d * cpu_pod) / view.cpu_sum
                  <= cfg.cpu_threshold)
        mem_ok = ((view.mem_cur + cfg.w_e * mem_pod) / view.mem_sum
                  <= cfg.mem_threshold)
        cold = ~torch.as_tensor(hot, device=free_mask.device)
        return torch.nonzero(cpu_ok & mem_ok & cold & free_mask)[:, 0] \
            .cpu().numpy()

    # -------- planning --------

    def plan(self, cluster, view, hot, exclude_uids=frozenset(),
             corrections=None, attribution=None, proactive=None,
             forecast_pressure=None, recorder=None) -> list[Action]:
        """view: the ``ClusterView`` telemetry snapshot.
        exclude_uids: pods recently acted on (per-pod anti-ping-pong).
        corrections: per-kind multiplicative calibration of
            ``predicted_reduction`` (missing kinds default to 1.0).
        attribution: (N, S) per-slot drift scores from the detector.
        proactive: optional (N,) bool mask of nodes flagged from forecast
            drift only: their candidates cost ``proactive_cost_scale`` and
            are tagged ``proactive=True``.
        forecast_pressure: optional (N,) forecast run-queue pressure at
            which a proactive node's relief is priced (host values).
        recorder: optional ``TraceRecorder``; each chosen action gets an
            ``action_id`` and an ``ActionPlanned`` event recording the
            greedy ranking it won (correction, net gain, rank).
        """
        hot = np.asarray(hot, bool)
        corrections = corrections or {}
        proactive = (np.zeros(hot.shape, bool) if proactive is None
                     else np.asarray(proactive, bool))
        candidates: list[Action] = []
        for node in np.nonzero(hot)[0]:
            node = int(node)
            rho_override = None
            if proactive[node] and forecast_pressure is not None:
                rho_override = float(forecast_pressure[node])
            candidates.extend(
                self._candidates(cluster, view, node, hot, exclude_uids,
                                 attribution, rho_override=rho_override,
                                 proactive=bool(proactive[node])))

        def net_gain(a: Action) -> float:
            calibrated = corrections.get(a.kind, 1.0) * a.predicted_reduction
            return calibrated - self.cfg.cost_weight * a.cost

        candidates = [a for a in candidates if net_gain(a) > 0]
        candidates.sort(key=net_gain, reverse=True)
        chosen, spent, per_node = [], 0.0, {}
        used_uids: set[int] = set()
        for a in candidates:
            if spent + a.cost > self.cfg.budget:
                continue
            if per_node.get(a.node, 0) >= self.cfg.max_actions_per_node:
                continue
            # one action per pod: migrate + scale-out of one victim (or
            # evict + resize of one job) conflict and double-count relief
            uid = getattr(a, "uid", -1)
            if uid in used_uids:
                continue
            chosen.append(a)
            spent += a.cost
            per_node[a.node] = per_node.get(a.node, 0) + 1
            used_uids.add(uid)
        if recorder:
            from repro_torch.obs import ActionPlanned

            for rank, a in enumerate(chosen):
                a.action_id = recorder.next_action_id()
                recorder.emit(ActionPlanned(
                    action=a.kind, action_id=a.action_id, node=a.node,
                    uid=getattr(a, "uid", -1), dst=getattr(a, "dst", -1),
                    cost=a.cost, predicted_reduction=a.predicted_reduction,
                    correction=corrections.get(a.kind, 1.0),
                    net_gain=net_gain(a), rank=rank, proactive=a.proactive,
                ))
        return chosen

    def _candidates(self, cluster, view, node: int, hot: np.ndarray,
                    exclude_uids=frozenset(), attribution=None,
                    rho_override=None, proactive=False) -> list[Action]:
        cfg = self.cfg
        pods = cluster.pods_on_node(node)
        eligible = [p for p in pods if p["uid"] not in exclude_uids]
        offline = [p for p in eligible if p["kind"] == "off"]
        online = [p for p in eligible if p["kind"] == "on"]
        cores = float(view.cpu_sum[node])
        node_params = _node_delay_params(view, node)
        rho_p = self._pressure(cluster, view, node, pods)  # all pods press
        if rho_override is not None:
            # never below the measured pressure (the forecast may lag)
            rho_p = max(rho_p, rho_override)
        out: list[Action] = []

        def drift(p: dict) -> float:
            """A pod's slot drift score (0 without attribution); offline
            slots sit after the S_ON online ones in the detector layout."""
            if attribution is None:
                return 0.0
            s = p["slot"] + (0 if p["kind"] == "on" else S_ON)
            return float(attribution[node, s])

        # offline offenders: drifted slot first, then cores x burst; each
        # gives an evict and a throttle candidate
        offline.sort(key=lambda p: (drift(p), p["cores"] * p["burst"]),
                     reverse=True)
        for job in offline[:cfg.max_actions_per_node + 1]:
            dcores = job["cores"] * job["burst"]
            out.append(EvictOffline(
                node=node, uid=job["uid"],
                cost=cfg.evict_cost_per_core * job["cores"],
                predicted_reduction=self._relief(rho_p, dcores, cores,
                                                 node_params),
            ))
            new_cores = job["cores"] * cfg.throttle_frac
            if new_cores < cfg.min_offline_cores:
                continue  # throttled to the floor already
            stretch = job["remaining"] * (1.0 / cfg.throttle_frac - 1.0)
            out.append(VerticalResize(
                node=node, uid=job["uid"],
                new_cores=new_cores,
                cost=cfg.resize_cost + 0.002 * stretch,
                predicted_reduction=self._relief(
                    rho_p, dcores * (1.0 - cfg.throttle_frac), cores,
                    node_params),
            ))

        if online and cfg.destination_actions:
            victim = max(online, key=lambda p: (drift(p), p["qps"]))
            prof = ONLINE_PROFILES[victim["workload"]]
            cpu_pod = prof.cpu_per_qps * victim["qps"] + prof.cpu_base
            mem_pod = prof.mem_per_qps * victim["qps"] + prof.mem_base
            on_free = ~cluster.state.on_active.all(1)
            # Eq. (3) on every node at once, on the device: latency units
            pred = (self.q.intf_pod(victim["qps"], view.features).cpu()
                    .numpy() * metric.OVERFLOW_EDGE)
            dsts = self._destinations(view, hot, cpu_pod, mem_pod, on_free)
            if dsts.size:
                # rank by predicted interference plus the topology's
                # transfer price of the pod's memory (1.0 on a flat fleet)
                factor = np.array([
                    view.migrate_cost_factor(node, int(d), mem_pod)
                    for d in dsts])
                eff = pred[dsts] + cfg.transfer_latency_weight * (factor - 1.0)
                j = int(np.argmin(eff))
                dst, dst_factor = int(dsts[j]), float(factor[j])
                # move only across a real predicted gap; the RF maps
                # pre-placement features to the runqlat the pod realised,
                # so pred[dst] already prices its own load there
                if pred[node] - pred[dst] > cfg.migrate_margin:
                    out.append(MigrateOnline(
                        node=node, uid=victim["uid"], dst=dst,
                        cost=cfg.migrate_cost * dst_factor,
                        predicted_reduction=self._relief(
                            rho_p, cpu_pod, cores, node_params)
                        + (pred[node] - pred[dst]),
                    ))
                half = victim["qps"] / 2.0
                if half >= cfg.min_scale_qps:
                    # the source keeps its cpu_base and the replica brings a
                    # new one to the destination: charge that added load
                    # against the destination's own delay curve
                    cpu_half = prof.cpu_per_qps * half
                    dst_cores = float(view.cpu_sum[dst])
                    rho_dst = float(view.cpu_cur[dst] / dst_cores)
                    dst_add = cpu_half + prof.cpu_base
                    dst_penalty = self._relief(
                        rho_dst + dst_add / dst_cores, dst_add, dst_cores,
                        _node_delay_params(view, dst))
                    mem_half = prof.mem_per_qps * half + prof.mem_base
                    out.append(ScaleOut(
                        node=node, uid=victim["uid"],
                        workload=victim["workload"], dst=dst,
                        replica_qps=half,
                        cost=cfg.scale_out_cost
                        * view.migrate_cost_factor(node, dst, mem_half),
                        predicted_reduction=self._relief(
                            rho_p, cpu_half, cores, node_params)
                        + 0.3 * max(pred[node] - pred[dst], 0.0)
                        - dst_penalty,
                    ))
        if proactive:
            for a in out:
                a.cost *= cfg.proactive_cost_scale
                a.proactive = True
        return out
