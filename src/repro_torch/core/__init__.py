"""The paper's core on tensors: the runqlat metric, Eq. 1/3 quantifier,
the Table II predictors, the resource model, ICO and its forecast-aware
variant ICO-F, and the RR/HUP/LQP baselines.

The runtime mitigation control plane (``repro_torch.control``) is
re-exported here lazily, as in ``repro.core``, so callers can write
``from repro_torch.core import ControlLoop`` without an import cycle.
"""
from repro_torch.core.baselines import (
    HUPScheduler,
    LQPScheduler,
    RoundRobinScheduler,
)
from repro_torch.core.interference import (
    InterferenceQuantifier,
    InterferenceWeights,
    node_interference,
    pod_interference,
)
from repro_torch.core.resource_model import ResourcePredictor
from repro_torch.core.scheduler import (
    ICOFScheduler,
    ICOScheduler,
    SchedulerConfig,
)

_CONTROL_EXPORTS = (
    "ControlLoop", "ControlLoopConfig", "ControlStats", "StreamingDetector",
    "DetectorConfig", "MitigationPolicy", "PolicyConfig", "Action",
    "EvictOffline", "MigrateOnline", "ScaleOut", "VerticalResize",
)

__all__ = [
    "HUPScheduler", "ICOFScheduler", "ICOScheduler",
    "InterferenceQuantifier", "InterferenceWeights", "LQPScheduler",
    "ResourcePredictor", "RoundRobinScheduler", "SchedulerConfig",
    "node_interference", "pod_interference", *_CONTROL_EXPORTS,
]


def __getattr__(name: str):
    if name in _CONTROL_EXPORTS:
        import repro_torch.control as control

        return getattr(control, name)
    raise AttributeError(
        f"module 'repro_torch.core' has no attribute {name!r}")
