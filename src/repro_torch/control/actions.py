"""Typed mitigation actions with cost estimates.

Port of ``repro.control.actions``.  Each action targets one hotspot node
and applies itself through the port's ``Cluster`` primitives (``place`` /
``remove`` / ``migrate`` / ``resize``), so every applied action lands in
``cluster.log`` as events ``extract_plan`` replays.
``predicted_reduction`` is the policy's estimate of the node runqlat
reduction (latency units) the action buys; ``cost`` is in the abstract
budget units the policy spends per control invocation:

  * evict-offline   -- lost batch work, proportional to the job's cores
  * migrate-online  -- connection draining / state transfer
  * scale-out       -- replica startup, the most expensive
  * vertical-resize -- a cgroup quota write, the cheapest

``apply`` returns True only when the cluster accepted the mutation; a pod
that finished or was removed between planning and acting makes the action
a no-op.  The ControlLoop stamps ``pre_runqlat`` (the node's window
average at apply time) and, one step later, ``realized_reduction``.
Actions planned from forecast drift carry ``proactive=True``; a traced
run's policy gives each chosen action the ``action_id`` that links its
Planned -> Executed -> Verified events.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.cluster.workloads import ONLINE_PROFILES, Pod


@dataclasses.dataclass
class Action:
    """Base mitigation action against one hotspot node."""

    node: int
    cost: float = 0.0
    predicted_reduction: float = 0.0
    proactive: bool = False             # planned from forecast drift
    pre_runqlat: float = math.nan       # source node avg runqlat at apply
    realized_reduction: float = math.nan  # observed delta, one step later
    action_id: int = -1                 # trace chain id (-1 untraced)

    kind = "noop"

    def apply(self, cluster) -> bool:
        raise NotImplementedError

    def describe(self) -> str:
        realized = ("" if math.isnan(self.realized_reduction)
                    else f", realized={self.realized_reduction:.1f}")
        tag = ", proactive" if self.proactive else ""
        return (f"{self.kind}(node={self.node}, cost={self.cost:.2f}, "
                f"pred_reduction={self.predicted_reduction:.1f}{realized}"
                f"{tag})")


@dataclasses.dataclass
class EvictOffline(Action):
    """Kill an offline batch job on the hotspot; its work is lost."""

    uid: int = -1
    kind = "evict_offline"

    def apply(self, cluster) -> bool:
        try:
            cluster.remove(self.uid)
        except KeyError:
            return False
        return True


@dataclasses.dataclass
class MigrateOnline(Action):
    """Live-migrate an online service to a less interfered node."""

    uid: int = -1
    dst: int = -1
    kind = "migrate_online"

    def apply(self, cluster) -> bool:
        try:
            return cluster.migrate(self.uid, self.dst)
        except KeyError:
            return False


@dataclasses.dataclass
class ScaleOut(Action):
    """Horizontal scale-out: split an online service's QPS with a new
    replica on another node, halving the pressure it exerts locally."""

    uid: int = -1
    workload: str = ""
    dst: int = -1
    replica_qps: float = 0.0
    kind = "scale_out"

    def apply(self, cluster) -> bool:
        prof = ONLINE_PROFILES[self.workload]
        replica = Pod(self.workload, self.replica_qps, True)
        replica.cpu_demand = (prof.cpu_per_qps * self.replica_qps
                              + prof.cpu_base)
        replica.mem_demand = (prof.mem_per_qps * self.replica_qps
                              + prof.mem_base)
        if not cluster.place(replica, self.dst):
            return False
        try:
            return cluster.resize(self.uid, qps=self.replica_qps)
        except KeyError:
            # the original vanished mid-flight: roll the replica back
            cluster.remove(replica.uid)
            return False


@dataclasses.dataclass
class VerticalResize(Action):
    """Throttle an offline job's cores (work conserved: it runs longer)."""

    uid: int = -1
    new_cores: float = 0.0
    kind = "vertical_resize"

    def apply(self, cluster) -> bool:
        try:
            return cluster.resize(self.uid, cores=self.new_cores)
        except KeyError:
            return False
