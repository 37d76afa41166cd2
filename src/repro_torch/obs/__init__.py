"""Observability for the port: the wall-clock phase timers.

The trace recorder, events and explain CLI of ``repro.obs`` are not ported
yet; ``repro_torch.cluster.experiment.run_experiment`` refuses a recorder.
"""
from repro_torch.obs.timers import PhaseTimers

__all__ = ["PhaseTimers"]
