"""Typed, JSONL-serializable decision-trace events (a copy of
``repro.obs.events``: the same schema, so a trace saved by either package
loads in the other's reader).

Every consequential decision the control plane makes — an admission, a
hotspot flag, a mitigation action moving through its
Planned -> Executed -> Verified/Discarded lifecycle, a trust-gate flip, a
retry-queue transition — is one event here.  Events carry three shared
tags assigned by the ``TraceRecorder`` at emit time:

  * ``seq``    — monotonic sequence number across the whole trace, so the
    exact interleaving of decisions is reconstructible;
  * ``window`` — index of the telemetry window the event belongs to (the
    experiment driver calls ``begin_window`` once per rollout slice);
  * ``t``      — the cluster clock at the start of that window.

The serialized form is one JSON object per line with an ``event`` type
tag; ``from_dict`` tolerates unknown fields (forward compatibility — a
newer trace loads in an older reader) and ``load`` maps unknown event
types to ``GenericEvent`` instead of failing, so traces stay readable
across schema evolution.

Arrays in event payloads (the per-node admission score breakdown) are
stored as plain lists rounded to 6 decimals: readable, diffable, and
small enough that a multi-day trace stays in the tens of megabytes.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np


def jsonable(value):
    """Recursively convert numpy scalars/arrays to JSON-friendly values."""
    if isinstance(value, np.ndarray):
        return jsonable(value.tolist())
    if isinstance(value, (np.bool_,)):
        return bool(value)
    if isinstance(value, (np.integer,)):
        return int(value)
    if isinstance(value, (np.floating,)):
        return jsonable(float(value))
    if isinstance(value, float):
        return round(value, 6) if math.isfinite(value) else value
    if isinstance(value, dict):
        return {str(k): jsonable(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [jsonable(v) for v in value]
    return value


@dataclasses.dataclass
class Event:
    """Base trace event; ``seq``/``window``/``t`` are stamped on emit."""

    seq: int = -1
    window: int = -1
    t: float = 0.0

    event = "event"  # type tag, overridden per subclass

    def to_dict(self) -> dict:
        d = {"event": type(self).event}
        d.update(jsonable(dataclasses.asdict(self)))
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Event":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


@dataclasses.dataclass
class AdmissionDecision(Event):
    """One scheduler decision: which node a pod was offered, and why.

    ``breakdown`` holds the per-node score decomposition — for ICO/ICO-F
    the Eq. (4)-(6) terms (``utiliz_cpu``, ``utiliz_mem``, ``intf_h``,
    ``intf_p``, the ICO-F ``forecast_term`` when the gate is open,
    ``feasible``, ``score``); baselines store their own scoring terms.
    ``uid``/``placed`` are resolved by the experiment driver after
    ``Cluster.place`` (the uid does not exist at scoring time); ``retry``
    marks offers replayed from the retry queue.
    """

    scheduler: str = ""
    workload: str = ""
    qps: float = 0.0
    online: bool = True
    cpu_demand: float = 0.0
    mem_demand: float = 0.0
    chosen: int = -1
    uid: int = -1
    placed: bool | None = None
    retry: bool = False
    breakdown: dict = dataclasses.field(default_factory=dict)

    event = "admission"


@dataclasses.dataclass
class HotspotFlag(Event):
    """Detector flag: which node tripped, on which channel, on what values.

    ``channel`` is ``drift`` (CUSUM over threshold), ``acute`` (decayed
    p-tail over ceiling), or ``forecast`` (forecast-CUSUM over the
    proactive threshold).  ``cusum``/``f_cusum`` are the *pre-consumption*
    trip values (the detector zeroes the accumulator on flagging);
    ``slot``/``slot_score`` carry the per-slot attribution when it cleared
    the floor (-1 / 0 otherwise).
    """

    node: int = -1
    channel: str = "drift"
    avg: float = 0.0
    mu: float = 0.0
    p_tail: float = 0.0
    cusum: float = 0.0
    f_cusum: float = 0.0
    slot: int = -1
    slot_score: float = 0.0

    event = "hotspot"


@dataclasses.dataclass
class ActionPlanned(Event):
    """A mitigation action chosen by the policy's greedy pass.

    ``correction`` is the per-kind EWMA calibration factor applied in the
    ranking; ``net_gain`` the calibrated reduction minus weighted cost the
    action was ranked by; ``rank`` its position in the chosen plan.
    ``action_id`` links the Planned -> Executed -> Verified chain.
    """

    action: str = ""
    action_id: int = -1
    node: int = -1
    uid: int = -1
    dst: int = -1
    cost: float = 0.0
    predicted_reduction: float = 0.0
    correction: float = 1.0
    net_gain: float = 0.0
    rank: int = -1
    proactive: bool = False

    event = "action_planned"


@dataclasses.dataclass
class ActionExecuted(Event):
    """A planned action the simulator actually accepted."""

    action: str = ""
    action_id: int = -1
    node: int = -1
    uid: int = -1
    dst: int = -1
    proactive: bool = False
    pre_runqlat: float = 0.0
    predicted_reduction: float = 0.0

    event = "action_executed"


@dataclasses.dataclass
class ActionVerified(Event):
    """Post-action resolution, one telemetry window after executing.

    ``outcome`` is ``verified`` (predicted vs realized compared,
    ``correction`` is the per-kind EWMA *after* this sample) or
    ``discarded`` (the node's pod signature changed between acting and
    checking, so the window measured churn — ``reason`` says why).
    Proactive actions never get one: the window they mitigate is still
    ``horizon`` steps ahead when the next window arrives.
    """

    action: str = ""
    action_id: int = -1
    node: int = -1
    outcome: str = "verified"
    predicted: float = 0.0
    realized: float = 0.0
    correction: float = 1.0
    reason: str = ""

    event = "action_verified"


@dataclasses.dataclass
class TrustGateTransition(Event):
    """A node's forecast trust gate opened or closed.

    ``leverage`` / ``rel_err`` are the best (minimum) extrapolation
    leverage and one-step relative-error EWMA across the node's active
    slots at the transition — the two statistics the gate is made of.
    """

    node: int = -1
    opened: bool = False
    leverage: float = math.nan
    rel_err: float = math.nan
    trusted_slots: int = 0

    event = "trust_gate"


@dataclasses.dataclass
class RetryQueued(Event):
    """A pod no scheduler would take entered the bounded retry queue."""

    workload: str = ""
    qps: float = 0.0
    attempts: int = 0
    reason: str = "no_feasible_node"

    event = "retry_queued"


@dataclasses.dataclass
class RetryDrained(Event):
    """One retry-queue drain attempt: re-offered and placed / requeued /
    rejected (attempts exhausted)."""

    workload: str = ""
    qps: float = 0.0
    outcome: str = "placed"
    uid: int = -1
    attempts: int = 0

    event = "retry_drained"


@dataclasses.dataclass
class PhaseTimings(Event):
    """Wall-clock seconds each control-plane phase spent this window
    (rollout / detect / forecast / plan / verify)."""

    timings: dict = dataclasses.field(default_factory=dict)

    event = "phase_timings"


@dataclasses.dataclass
class GenericEvent(Event):
    """Fallback for event types this reader does not know (forward
    compatibility: newer traces still load)."""

    payload: dict = dataclasses.field(default_factory=dict)

    event = "generic"

    def to_dict(self) -> dict:
        d = {"event": self.payload.get("event", "generic"),
             "seq": self.seq, "window": self.window, "t": self.t}
        d.update({k: v for k, v in self.payload.items()
                  if k not in ("event", "seq", "window", "t")})
        return jsonable(d)


EVENT_TYPES: dict[str, type[Event]] = {
    cls.event: cls
    for cls in (AdmissionDecision, HotspotFlag, ActionPlanned, ActionExecuted,
                ActionVerified, TrustGateTransition, RetryQueued, RetryDrained,
                PhaseTimings)
}


def event_from_dict(d: dict) -> Event:
    cls = EVENT_TYPES.get(d.get("event", ""))
    if cls is None:
        ev = GenericEvent(seq=d.get("seq", -1), window=d.get("window", -1),
                          t=d.get("t", 0.0), payload=dict(d))
        return ev
    return cls.from_dict(d)
