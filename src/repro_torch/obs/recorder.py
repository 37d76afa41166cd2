"""TraceRecorder — the decision-trace sink, and its zero-overhead twin (a
copy of ``repro.obs.recorder``).

A ``TraceRecorder`` is threaded (optionally) through the scheduler, the
control loop, and the forecast service; each emits typed events
(``repro_torch.obs.events``) describing the decision it just made.  The
recorder stamps every event with a monotonic ``seq`` and the current
telemetry ``window`` index, buffers in memory, and serializes to JSONL.

**Zero-overhead invariant**: tracing is disabled by default.  Every
instrumented call site guards with ``if recorder:`` — both ``None`` and
the ``NullRecorder`` are falsy — so a disabled run executes not one extra
attribute lookup beyond that truth test, never constructs an event, and
never perturbs RNG streams or control decisions.  A recorder-off run is
bit-identical to a run on a build without the instrumentation (enforced
by ``tests/test_torch_obs.py``); a recorder-ON run is *also* decision-identical,
because recording only observes — it never mutates cluster or policy
state.

``Trace`` is the load-side view: ``load_trace(path)`` returns one, with
query helpers the ``repro_torch.obs.explain`` CLI and the benches' chain checks
are built on.
"""
from __future__ import annotations

import json

from repro_torch.obs.events import (
    AdmissionDecision,
    Event,
    event_from_dict,
)


class TraceRecorder:
    """In-memory event sink with window/sequence tagging and JSONL I/O."""

    enabled = True

    def __init__(self):
        self.events: list[Event] = []
        self._seq = 0
        self._window = -1
        self._window_t = 0.0
        self._next_action_id = 0

    def __bool__(self) -> bool:  # `if recorder:` is the call-site guard
        return True

    def __len__(self) -> int:
        return len(self.events)

    # -------- window / id bookkeeping --------

    @property
    def window(self) -> int:
        """Index of the current telemetry window (-1 before the first)."""
        return self._window

    def begin_window(self, t: float) -> int:
        """Open the next telemetry window at cluster clock ``t``.

        Called once per rollout slice by whichever driver owns the cadence
        (``run_experiment``, ``ControlLoop.run``, or a hand-rolled demo
        loop); subsequent events belong to this window until the next call.
        """
        self._window += 1
        self._window_t = float(t)
        return self._window

    def next_action_id(self) -> int:
        """Fresh id linking one action's Planned/Executed/Verified events."""
        aid = self._next_action_id
        self._next_action_id += 1
        return aid

    # -------- emission --------

    def emit(self, event: Event) -> Event:
        event.seq = self._seq
        self._seq += 1
        event.window = self._window
        event.t = self._window_t
        self.events.append(event)
        return event

    def resolve_admission(self, uid: int, placed: bool,
                          retry: bool = False) -> None:
        """Bind the pod uid / placement outcome onto the latest admission.

        The scheduler emits ``AdmissionDecision`` at scoring time, before
        the pod has a uid (``Cluster.place`` assigns it) and before the
        placement can still fail on a full slot; the driver calls this
        right after the place attempt.  Tolerant no-op when there is no
        unresolved admission (a driver that never traces admissions).
        """
        for ev in reversed(self.events):
            if isinstance(ev, AdmissionDecision):
                if ev.placed is None:
                    ev.uid = int(uid)
                    ev.placed = bool(placed)
                    ev.retry = bool(retry)
                return

    # -------- query / I/O --------

    def query(self, event: str | None = None, **match) -> list[Event]:
        return _query(self.events, event, match)

    def save(self, path: str) -> int:
        """Serialize the trace as JSONL; returns the event count."""
        with open(path, "w") as f:
            for ev in self.events:
                f.write(json.dumps(ev.to_dict()) + "\n")
        return len(self.events)


class NullRecorder:
    """No-op recorder: same surface as ``TraceRecorder``, falsy, free.

    Exists so code can hold "a recorder" unconditionally and keep the
    ``if recorder:`` guard as the only branch; ``None`` works identically
    at every call site.
    """

    enabled = False

    def __bool__(self) -> bool:
        return False

    def __len__(self) -> int:
        return 0

    window = -1

    def begin_window(self, t: float) -> int:
        return -1

    def next_action_id(self) -> int:
        return -1

    def emit(self, event: Event) -> Event:
        return event

    def resolve_admission(self, uid: int, placed: bool,
                          retry: bool = False) -> None:
        return None

    def query(self, event: str | None = None, **match) -> list[Event]:
        return []


NULL_RECORDER = NullRecorder()


def _query(events, event, match):
    out = []
    for ev in events:
        if event is not None and type(ev).event != event:
            continue
        if all(getattr(ev, k, None) == v for k, v in match.items()):
            out.append(ev)
    return out


class Trace:
    """Loaded decision trace with the query helpers ``explain`` builds on."""

    def __init__(self, events: list[Event]):
        self.events = events

    def __len__(self) -> int:
        return len(self.events)

    def query(self, event: str | None = None, **match) -> list[Event]:
        return _query(self.events, event, match)

    def admissions_for(self, uid: int) -> list[Event]:
        """Every admission decision that ended with this pod uid (placed
        offers only — unplaced offers never receive a uid)."""
        return self.query("admission", uid=uid)

    def action_chain(self, action_id: int) -> dict:
        """The Planned / Executed / Verified events of one action id."""
        chain = {"planned": None, "executed": None, "verified": None}
        for ev in self.events:
            kind = type(ev).event
            if getattr(ev, "action_id", None) != action_id:
                continue
            if kind == "action_planned":
                chain["planned"] = ev
            elif kind == "action_executed":
                chain["executed"] = ev
            elif kind == "action_verified":
                chain["verified"] = ev
        return chain

    def last_window(self) -> int:
        return max((ev.window for ev in self.events), default=-1)


def load_trace(path: str) -> Trace:
    """Load a JSONL trace saved by ``TraceRecorder.save``."""
    events: list[Event] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                events.append(event_from_dict(json.loads(line)))
    return Trace(events)
