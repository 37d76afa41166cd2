"""Discrete-time co-location cluster simulator on tensors.

Port of ``repro.cluster.simulator``.  ``Cluster`` is the stateful shell the
drivers talk to: it owns the host-side bookkeeping (pod-uid map, the numpy
RNG for phases and bursts, the replayable mutation log), delegates every
mutation to the pure transforms of ``repro_torch.cluster.state``, and
advances time through ``state.rollout_chunks``.

Tick randomness comes from a per-chunk noise stream: by default
``state.chunk_noise_stream`` over a ``torch.Generator`` on the cluster's
device seeded with ``seed``; a caller may pass its own stream (``noise=``),
which is how the tests replay JAX's draws.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.cluster import state as cstate
from repro_torch.cluster import workloads as W
from repro_torch.cluster.fleet import Fleet
from repro_torch.cluster.state import (
    CHUNK,
    RHO_EPS,
    RUNQLAT_BASE,
    RUNQLAT_SCALE,
    S_OFF,
    S_ON,
    ClusterState,
)
from repro_torch.cluster.workloads import Pod
from repro_torch.device import resolve_device

__all__ = ["Cluster", "ClusterState", "Fleet", "NodeSpec"]


@dataclasses.dataclass(frozen=True)
class NodeSpec:
    """Per-node capacity of a homogeneous cluster."""
    cores: float = 32.0
    mem_gb: float = 64.0


class Cluster:
    """Host-side cluster manager: a thin stateful shell over ClusterState."""

    CHUNK = CHUNK

    def __init__(self, num_nodes: int = 12, spec: NodeSpec | None = None,
                 seed: int = 0, fleet: Fleet | None = None, *, device=None,
                 noise=None):
        self.device = resolve_device(device)
        if fleet is not None:
            if spec is not None:
                raise ValueError(
                    "pass capacities via the fleet's machine classes, "
                    "not a NodeSpec")
            num_nodes = fleet.num_nodes
            self.spec = None
            self.state = ClusterState.create(
                num_nodes, fleet.cores(), fleet.mem_gb(), device=self.device)
            self.fleet_params = fleet.params(device=self.device)
        else:
            spec = NodeSpec() if spec is None else spec
            self.spec = spec
            self.state = ClusterState.create(num_nodes, spec.cores,
                                             spec.mem_gb, device=self.device)
            self.fleet_params = cstate.FleetParams.uniform(
                num_nodes, device=self.device)
        self.n = num_nodes
        self.fleet = fleet
        self.rng = np.random.default_rng(seed)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.noise = (iter(noise) if noise is not None
                      else cstate.chunk_noise_stream(self.generator,
                                                     num_nodes))
        self.t = 0.0
        self.profiles = {k: torch.as_tensor(v, device=self.device)
                         for k, v in W.online_arrays().items()}
        self.last: dict | None = None
        self._pod_slots: dict[int, tuple[str, int, int]] = {}
        self._uid = 0
        # replayable mutation events: (op, t, node, slot, *params)
        self.log: list[tuple] = []

    # ---------------- placement ----------------

    def _free_slot(self, active: torch.Tensor, node: int) -> int:
        free = np.nonzero(~active[node].cpu().numpy())[0]
        return int(free[0]) if free.size else -1

    def place(self, pod: Pod, node: int) -> bool:
        """Place a pod on a node. Returns False if the node has no free slot."""
        if node < 0 or node >= self.n:
            return False
        if pod.is_online:
            s = self._free_slot(self.state.on_active, node)
            if s < 0:
                return False
            prof = W.ONLINE_PROFILES[pod.workload]
            phase = float(self.rng.uniform(0, 2 * np.pi))
            self.state = cstate.place_online(
                self.state, node, s, prof.type_id, float(pod.qps), phase)
            self.log.append(("place_on", self.t, node, s,
                             prof.type_id, float(pod.qps), phase))
            kind = "on"
        else:
            s = self._free_slot(self.state.off_active, node)
            if s < 0:
                return False
            prof = W.OFFLINE_PROFILES[pod.workload]
            cores = float(pod.cpu_demand)
            threads = float(cores * prof.threads_per_core)
            mem = float(cores * prof.mem_per_core)
            burst = float(self.rng.uniform(*prof.burst_range))
            remaining = int(pod.duration)
            self.state = cstate.place_offline(
                self.state, node, s, cores, threads, mem, burst, remaining)
            self.log.append(("place_off", self.t, node, s,
                             cores, threads, mem, burst, remaining))
            kind = "off"
        pod.uid = self._uid
        self._pod_slots[pod.uid] = (kind, node, s)
        self._uid += 1
        return True

    def remove(self, uid: int) -> None:
        # reconcile first so a tick-expired offline uid raises KeyError
        # instead of double-evicting a slot the tick already deactivated
        self.reconcile()
        if uid not in self._pod_slots:
            raise KeyError(
                f"unknown pod uid {uid}: never placed, already removed, or a "
                f"finished offline job cleared by reconcile()")
        kind, node, s = self._pod_slots.pop(uid)
        if kind == "on":
            self.state = cstate.evict_online(self.state, node, s)
        else:
            self.state = cstate.evict_offline(self.state, node, s)
        self.log.append((f"evict_{kind}", self.t, node, s))

    def reconcile(self) -> list[int]:
        """Clear offline jobs whose run finished; returns their uids."""
        off_active = self.state.off_active.cpu().numpy()
        finished = [
            uid for uid, (kind, node, s) in self._pod_slots.items()
            if kind == "off" and not off_active[node, s]
        ]
        for uid in finished:
            self._pod_slots.pop(uid)
        if finished:
            self.state, _ = cstate.reconcile(self.state)
        return finished

    # ---------------- runtime mitigation primitives ----------------

    def migrate(self, uid: int, dst: int) -> bool:
        """Move a live pod to another node, preserving its parameters.
        False when the destination has no free slot; KeyError for unknown
        uids."""
        self.reconcile()
        if uid not in self._pod_slots:
            raise KeyError(f"cannot migrate unknown pod uid {uid}")
        kind, src, s = self._pod_slots[uid]
        if dst < 0 or dst >= self.n:
            return False
        if dst == src:
            return True
        d = self._free_slot(getattr(self.state, f"{kind}_active"), dst)
        if d < 0:
            return False
        mover = (cstate.migrate_online if kind == "on"
                 else cstate.migrate_offline)
        self.state = mover(self.state, src, s, dst, d)
        self.log.append((f"migrate_{kind}", self.t, src, s, dst, d))
        self._pod_slots[uid] = (kind, dst, d)
        return True

    def resize(self, uid: int, *, cores: float | None = None,
               qps: float | None = None) -> bool:
        """Vertically resize a live pod in place (offline: work-conserving
        core rescale; online: new mean QPS)."""
        self.reconcile()
        if uid not in self._pod_slots:
            raise KeyError(f"cannot resize unknown pod uid {uid}")
        kind, node, s = self._pod_slots[uid]
        if kind == "off":
            if cores is None or cores <= 0:
                return False
            old = float(self.state.off_cores[node, s])
            if old <= 0:
                return False
            ratio = cores / old
            new_threads = float(self.state.off_threads[node, s]) * ratio
            new_mem = float(self.state.off_mem[node, s]) * ratio
            rem = int(self.state.off_remaining[node, s])
            new_rem = max(int(round(rem / ratio)), 1)
            self.state = cstate.resize_offline(
                self.state, node, s, old * ratio, new_threads, new_mem,
                new_rem)
            self.log.append(("resize_off", self.t, node, s,
                             old * ratio, new_threads, new_mem, 0.0, new_rem))
        else:
            if qps is None or qps < 0:
                return False
            self.state = cstate.resize_online(self.state, node, s, float(qps))
            self.log.append(("resize_on", self.t, node, s, float(qps)))
        return True

    def slot_uids(self) -> np.ndarray:
        """(N, S_ON + S_OFF) tenant uid per slot, -1 when vacant (online
        slots first, offline offset by S_ON)."""
        self.reconcile()
        uids = np.full((self.n, S_ON + S_OFF), -1, np.int64)
        for uid, (kind, node, s) in self._pod_slots.items():
            uids[node, s if kind == "on" else S_ON + s] = uid
        return uids

    # ---------------- simulation ----------------

    def rollout(self, num_ticks: int) -> dict:
        """Advance ~num_ticks ticks (rounded up to CHUNK multiples).

        ``self.last`` holds the merged window summary as tensors on the
        cluster's device.
        """
        chunks = max(1, -(-num_ticks // self.CHUNK))
        self.state, parts = cstate.rollout_chunks(
            self.state, self.profiles, self.fleet_params, self.t, chunks,
            self.noise)
        self.t += chunks * self.CHUNK
        self.last = cstate.merge_summaries(parts)
        self.reconcile()
        return self.last

    def rollout_scan(self, num_ticks: int) -> dict:
        """The JAX package's single-dispatch rollout path.  Here it shares
        ``rollout``'s chunk loop (capturing that loop in a CUDA graph is
        later work), so the two are bitwise equal by construction."""
        return self.rollout(num_ticks)

    # ---------------- Data Collection Module ----------------

    def view(self):
        """Typed collector snapshot consumed by every scheduler (paper
        Sec. IV-A), built from the state and the last window's telemetry."""
        if self.last is None:
            self.rollout(30)
        from repro_torch.cluster.view import ClusterView
        from repro_torch.core.predictors.features import runqlat_summary

        s = self.last
        node_hist = s["hist_on"].sum(1) + s["hist_off"].sum(1)  # (N, 200)
        features = torch.cat([s["perf"], s["hw"], runqlat_summary(node_hist)],
                             dim=1)
        on_active = self.state.on_active
        slot_hists = torch.cat([s["hist_on"], s["hist_off"]], dim=1)
        off_pressure = (self.state.off_cores * self.state.off_burst
                        * self.state.off_active).sum(-1)
        if self.fleet is not None:
            d64 = self.fleet.delay_params64()
            node_class = self.fleet.class_names()
        else:
            d64 = {"base": np.full(self.n, RUNQLAT_BASE, np.float64),
                   "scale": np.full(self.n, RUNQLAT_SCALE, np.float64),
                   "knee": np.full(self.n, RHO_EPS, np.float64)}
            node_class = None
        return ClusterView(
            t=float(self.t),
            cpu_cur=s["cpu_demand"],
            cpu_sum=self.state.cpu_sum,
            mem_cur=s["mem_used"],
            mem_sum=self.state.mem_sum,
            online_hists=s["hist_on"],
            offline_hists=s["hist_off"],
            slot_hists=slot_hists,
            features=features,
            online_qps=s["qps"],
            online_qps_sum=(s["qps"] * on_active).sum(-1),
            on_active=on_active,
            on_type=self.state.on_type,
            off_pressure=off_pressure,
            cpu_util=s["cpu_util"],
            mem_util=s["mem_util"],
            slot_uids=self.slot_uids(),
            node_class=node_class,
            fleet=self.fleet,
            delay_base=d64["base"],
            delay_scale=d64["scale"],
            rho_knee=d64["knee"],
        )

    def online_rt_samples(self) -> torch.Tensor:
        """Flat response-time samples of all active online pods in the last
        window (a tensor on the cluster's device)."""
        rt = self.last["rt"]  # (W, N, S_ON)
        mask = self.state.on_active.expand(rt.shape)
        return rt[mask & (rt > 0)]
