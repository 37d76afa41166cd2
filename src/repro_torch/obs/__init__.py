"""Observability for the port: decision traces, the metrics registry and
the wall-clock phase timers.

Plain numpy and the standard library, as in ``repro.obs``: the control
plane and the experiment driver import this unconditionally, and trace
readers (the ``python -m repro_torch.obs.explain`` CLI, the benches' chain
checks) work without a card.  The JSONL schema is the JAX package's, so a
trace saved by either package loads in the other's reader.
"""
from repro_torch.obs.events import (
    EVENT_TYPES,
    ActionExecuted,
    ActionPlanned,
    ActionVerified,
    AdmissionDecision,
    Event,
    GenericEvent,
    HotspotFlag,
    PhaseTimings,
    RetryDrained,
    RetryQueued,
    TrustGateTransition,
    event_from_dict,
    jsonable,
)
from repro_torch.obs.metrics import (
    Counter,
    Gauge,
    MetricsRegistry,
    WindowedHistogram,
)
from repro_torch.obs.recorder import (
    NULL_RECORDER,
    NullRecorder,
    Trace,
    TraceRecorder,
    load_trace,
)
from repro_torch.obs.timers import PhaseTimers

__all__ = [
    "ActionExecuted", "ActionPlanned", "ActionVerified", "AdmissionDecision",
    "Counter", "EVENT_TYPES", "Event", "Gauge", "GenericEvent", "HotspotFlag",
    "MetricsRegistry", "NULL_RECORDER", "NullRecorder", "PhaseTimers",
    "PhaseTimings", "RetryDrained", "RetryQueued", "Trace", "TraceRecorder",
    "TrustGateTransition", "WindowedHistogram", "event_from_dict",
    "jsonable", "load_trace",
]
