from repro_torch.train.checkpoint import Checkpointer
from repro_torch.train.fault import Preemptible, StragglerDetector, StragglerPolicy
from repro_torch.train.train_step import init_train_state, make_train_step

__all__ = ["make_train_step", "init_train_state", "Checkpointer",
           "StragglerDetector", "StragglerPolicy", "Preemptible"]
