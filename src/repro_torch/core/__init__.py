"""The paper's core on tensors: the runqlat metric, Eq. 1/3 quantifier,
the Random-Forest predictor, ICO and the RR/HUP/LQP baselines."""
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
from repro_torch.core.scheduler import ICOScheduler, SchedulerConfig

__all__ = [
    "HUPScheduler", "ICOScheduler", "InterferenceQuantifier",
    "InterferenceWeights", "LQPScheduler", "RoundRobinScheduler",
    "SchedulerConfig", "node_interference", "pod_interference",
]
