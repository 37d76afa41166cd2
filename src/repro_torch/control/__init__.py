"""Runtime interference-mitigation control plane (detect -> rank -> act
-> verify), the reactive half of ``repro.control``.

  detect  (``detector``) -- decayed per-(node, slot) runqlat histograms, a
      CUSUM drift statistic and a tail ceiling per node, per-slot drift
      attribution; one batch of tensor operations over the cluster.
  rank    (``policy``) -- per hotspot, candidate mitigations scored by
      predicted runqlat reduction (the delay curve for source relief, the
      Eq. (3) Random Forest for destinations), chosen greedily under a
      budget.
  act     (``actions``) -- evict-offline, migrate-online, scale-out,
      vertical-resize, applied through the ``Cluster`` primitives.
  forecast (``forecast``) -- a per-pod decayed diurnal-harmonic QPS
      regression (one batched update on the device) projects node runqlat
      ``horizon`` windows ahead through the delay curve; the detector's
      forecast channel turns predicted drift into proactive flags.  The
      ``ForecastService`` owning it is shared by the loop and ICO-F.
  verify  (``loop``) -- one window after acting, predicted against
      realized reduction; a per-kind correction feeds back into the
      ranking.

``loop.ControlLoop`` ties them together; ``run_experiment(...,
control_loop=...)`` and ``compare_schedulers(..., control=True)`` rerun
the Figs. 13-15 comparison with mitigation, ``proactive=`` and
``forecast=`` with the forecast channel and ICO-F.
"""
from repro_torch.control.actions import (
    Action,
    EvictOffline,
    MigrateOnline,
    ScaleOut,
    VerticalResize,
)
from repro_torch.control.detector import DetectorConfig, StreamingDetector
from repro_torch.control.forecast import (
    ForecastConfig,
    ForecastService,
    NodeProjection,
    QPSForecaster,
    project_node_pressure,
)
from repro_torch.control.loop import (
    SCHEDULER_PROFILES,
    ControlLoop,
    ControlLoopConfig,
    ControlStats,
    scheduler_loop_config,
)
from repro_torch.control.policy import (
    MitigationPolicy,
    PolicyConfig,
    node_delay_curve,
    view_delay_params,
)

__all__ = [
    "Action", "ControlLoop", "ControlLoopConfig", "ControlStats",
    "DetectorConfig", "EvictOffline", "ForecastConfig", "ForecastService",
    "MigrateOnline", "MitigationPolicy", "NodeProjection", "PolicyConfig",
    "QPSForecaster", "SCHEDULER_PROFILES", "ScaleOut", "StreamingDetector",
    "VerticalResize", "node_delay_curve", "project_node_pressure",
    "scheduler_loop_config", "view_delay_params",
]
