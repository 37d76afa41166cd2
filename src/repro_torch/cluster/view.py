"""ClusterView -- the Data Collection Module snapshot (paper Sec. IV-A).

Port of ``repro.cluster.view``.  One telemetry window of the whole cluster
as a dataclass: telemetry fields are tensors on the cluster's device, the
per-node delay-curve parameters are float64 numpy arrays built from the
``MachineClass`` Python floats (never widened from float32), and the tenant
map ``slot_uids`` is the host-side numpy array the shell keeps.

The control plane reads ``node_runqlat_avg`` (cached per view) and the
topology prices ``zone_of`` / ``transfer_cost`` / ``migrate_cost_factor``.

The forecast fields (``forecast_runqlat`` / ``forecast_rho`` /
``forecast_trusted``) are filled by ``ForecastService.annotate``: float64
and bool tensors on the service's device, the per-node runqlat the shared
projection expects ``horizon`` windows ahead.  They default to ``None``,
and ``forecast_drift()`` is then ``None`` too, so ICO-F scores exactly as
ICO.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import metric


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
    # --- filled by ForecastService.annotate (None = channel closed) ---
    forecast_runqlat: torch.Tensor | None = None  # (N,) float64 projection
    forecast_rho: torch.Tensor | None = None      # (N,) float64 pressure,
                                                  #      clamped at rho_cap
    forecast_trusted: torch.Tensor | None = None  # (N,) >= 1 pod trusted
    node_class: tuple[str, ...] | None = None    # (N,) machine-class names
    fleet: object | None = None                  # repro_torch.cluster.fleet.Fleet
    delay_base: np.ndarray | None = None         # (N,) float64
    delay_scale: np.ndarray | None = None        # (N,) float64
    rho_knee: np.ndarray | None = None           # (N,) float64

    _node_runqlat_avg: torch.Tensor | None = dataclasses.field(
        default=None, init=False, repr=False, compare=False)

    @property
    def num_nodes(self) -> int:
        return len(self.cpu_sum)

    def node_runqlat_avg(self) -> torch.Tensor:
        """(N,) average runqlat of this window's node histograms, on the
        view's device (cached)."""
        if self._node_runqlat_avg is None:
            hists = self.slot_hists
            if hists is None:
                hists = torch.cat([self.online_hists, self.offline_hists], 1)
            self._node_runqlat_avg = metric.avg_runqlat(hists.sum(1))
        return self._node_runqlat_avg

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
            forecast_runqlat=take(self.forecast_runqlat),
            forecast_rho=take(self.forecast_rho),
            forecast_trusted=take(self.forecast_trusted),
            node_class=(None if self.node_class is None
                        else tuple(self.node_class[i] for i in idx_np)),
            fleet=None,
            delay_base=take(self.delay_base),
            delay_scale=take(self.delay_scale),
            rho_knee=take(self.rho_knee),
        )

    def zone_of(self, node: int) -> int:
        """Availability zone of a node (0 on a topology-less view)."""
        if self.fleet is None:
            return 0
        return self.fleet.topology.zone_of(node)

    def transfer_cost(self, src: int, dst: int, gb: float) -> float:
        """Seconds to move ``gb`` GB src -> dst over the bottleneck link; a
        topology-less view prices every pair at the same-rack rate."""
        if self.fleet is None:
            from repro_torch.cluster.fleet import Topology
            return Topology.flat(self.num_nodes).transfer_cost(src, dst, gb)
        return self.fleet.topology.transfer_cost(src, dst, gb)

    def migrate_cost_factor(self, src: int, dst: int, gb: float) -> float:
        """Transfer cost relative to the same-rack price (1.0 without a
        topology)."""
        if self.fleet is None:
            return 1.0
        return self.fleet.topology.cost_factor(src, dst, gb)

    def forecast_drift(self) -> torch.Tensor | None:
        """(N,) float64 projected runqlat increase at the horizon, in
        latency units: ``None`` while the forecast channel is closed, zero
        on nodes with no trusted pod (so forecast-aware scoring degrades
        exactly to present-time scoring when the gate is shut)."""
        if self.forecast_runqlat is None:
            return None
        drift = torch.clamp_min(
            self.forecast_runqlat - self.node_runqlat_avg(), 0.0)
        if self.forecast_trusted is not None:
            drift = torch.where(self.forecast_trusted, drift, 0.0)
        return drift
