"""Observability for the port: the wall-clock phase timers and the metrics
registry the control loop keeps its counters in.

The trace recorder, events and explain CLI of ``repro.obs`` are not ported
yet; ``run_experiment(recorder=)`` and ``ControlLoop(recorder=)`` refuse
one.
"""
from repro_torch.obs.metrics import (
    Counter,
    Gauge,
    MetricsRegistry,
    WindowedHistogram,
)
from repro_torch.obs.timers import PhaseTimers

__all__ = ["Counter", "Gauge", "MetricsRegistry", "PhaseTimers",
           "WindowedHistogram"]
