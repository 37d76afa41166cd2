"""The paper's core on tensors: the runqlat metric, Eq. 1/3 quantifier,
the Table II predictors, the resource model, ICO and the RR/HUP/LQP
baselines."""
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
from repro_torch.core.scheduler import ICOScheduler, SchedulerConfig

__all__ = [
    "HUPScheduler", "ICOScheduler", "InterferenceQuantifier",
    "InterferenceWeights", "LQPScheduler", "ResourcePredictor",
    "RoundRobinScheduler", "SchedulerConfig", "node_interference",
    "pod_interference",
]
