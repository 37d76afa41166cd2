"""The co-location cluster simulator on tensors and its experiment driver."""
from repro_torch.cluster.experiment import (
    ExperimentResult,
    compare_schedulers,
    make_schedulers,
    run_experiment,
    train_default_predictor,
)
from repro_torch.cluster.fleet import Fleet, MachineClass, make_fleet
from repro_torch.cluster.simulator import Cluster, NodeSpec
from repro_torch.cluster.view import ClusterView
from repro_torch.cluster.workloads import Pod

__all__ = [
    "Cluster", "ClusterView", "ExperimentResult", "Fleet", "MachineClass",
    "NodeSpec", "Pod", "compare_schedulers", "make_fleet", "make_schedulers",
    "run_experiment", "train_default_predictor",
]
