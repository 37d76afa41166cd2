"""ClusterView -- the Data Collection Module snapshot (paper Sec. IV-A).

Port of ``repro.cluster.view``.  One telemetry window of the whole cluster
as a dataclass: telemetry fields are tensors on the cluster's device, the
per-node delay-curve parameters are float64 numpy arrays built from the
``MachineClass`` Python floats (never widened from float32), and the tenant
map ``slot_uids`` is the host-side numpy array the shell keeps.

The forecast fields of the JAX view belong to the control-plane slice and
are not here yet.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class ClusterView:
    """Snapshot of one telemetry window across all nodes.

    Shapes: N nodes, S_ON/S_OFF online/offline slots, S = S_ON + S_OFF
    (online slots first), B = 200 bins, F = Table-III feature columns.
    """

    t: float = 0.0
    cpu_cur: torch.Tensor | None = None          # (N,) window-mean CPU demand
    cpu_sum: torch.Tensor | None = None          # (N,) node CPU capacity
    mem_cur: torch.Tensor | None = None          # (N,) window-mean MEM used
    mem_sum: torch.Tensor | None = None          # (N,) node MEM capacity
    online_hists: torch.Tensor | None = None     # (N, S_ON, B)
    offline_hists: torch.Tensor | None = None    # (N, S_OFF, B)
    slot_hists: torch.Tensor | None = None       # (N, S, B)
    features: torch.Tensor | None = None         # (N, F) float32
    online_qps: torch.Tensor | None = None       # (N, S_ON) window-mean QPS
    online_qps_sum: torch.Tensor | None = None   # (N,)
    on_active: torch.Tensor | None = None        # (N, S_ON) bool
    on_type: torch.Tensor | None = None          # (N, S_ON) int32
    off_pressure: torch.Tensor | None = None     # (N,) burst-weighted cores
    cpu_util: torch.Tensor | None = None         # (N,)
    mem_util: torch.Tensor | None = None         # (N,)
    slot_uids: np.ndarray | None = None          # (N, S) tenant uid, -1 vacant
    node_class: tuple[str, ...] | None = None    # (N,) machine-class names
    fleet: object | None = None                  # repro_torch.cluster.fleet.Fleet
    delay_base: np.ndarray | None = None         # (N,) float64
    delay_scale: np.ndarray | None = None        # (N,) float64
    rho_knee: np.ndarray | None = None           # (N,) float64

    @property
    def num_nodes(self) -> int:
        return len(self.cpu_sum)

    def take(self, idx) -> "ClusterView":
        """A candidate sub-view with every per-node leading axis sliced to
        ``idx``.  The ``fleet`` handle is dropped (its node indices would
        dangle); ``node_class`` and the delay params are re-indexed."""
        if isinstance(idx, torch.Tensor):
            idx_t, idx_np = idx, idx.cpu().numpy()
        else:
            idx_np = np.asarray(idx)
            idx_t = torch.as_tensor(idx_np)

        def take(a):
            if a is None:
                return None
            if isinstance(a, torch.Tensor):
                return a[idx_t.to(a.device)]
            return np.asarray(a)[idx_np]

        return dataclasses.replace(
            self,
            cpu_cur=take(self.cpu_cur), cpu_sum=take(self.cpu_sum),
            mem_cur=take(self.mem_cur), mem_sum=take(self.mem_sum),
            online_hists=take(self.online_hists),
            offline_hists=take(self.offline_hists),
            slot_hists=take(self.slot_hists), features=take(self.features),
            online_qps=take(self.online_qps),
            online_qps_sum=take(self.online_qps_sum),
            on_active=take(self.on_active), on_type=take(self.on_type),
            off_pressure=take(self.off_pressure),
            cpu_util=take(self.cpu_util), mem_util=take(self.mem_util),
            slot_uids=take(self.slot_uids),
            node_class=(None if self.node_class is None
                        else tuple(self.node_class[i] for i in idx_np)),
            fleet=None,
            delay_base=take(self.delay_base),
            delay_scale=take(self.delay_scale),
            rho_knee=take(self.rho_knee),
        )
