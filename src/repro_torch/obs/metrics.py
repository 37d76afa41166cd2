"""Metrics registry: counters, gauges, windowed histograms (a copy of
``repro.obs.metrics``).

The control loop increments named counters here and ``ControlLoop.stats``
assembles a ``ControlStats`` snapshot on demand.  Metrics are always on: a
Python attribute increment per event.  Names are dot-separated;
``counters(prefix)`` iterates a family (the loop uses
``applied_kind.<action>`` for the per-kind breakdown).  Histograms keep a
bounded ring of recent observations, so windowed percentiles stay bounded
on long runs.
"""
from __future__ import annotations

from collections import deque

import numpy as np


class Counter:
    """Monotonic float counter."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, v: float = 1.0) -> float:
        self.value += v
        return self.value


class Gauge:
    """Last-write-wins value."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> float:
        self.value = float(v)
        return self.value


class WindowedHistogram:
    """Bounded ring of recent observations with lifetime count/total.

    Percentiles are computed over the ring (the recent window — the part
    that matters for "how is this phase behaving *now*"), while ``count``
    and ``total`` track the whole run so means stay exact.
    """

    __slots__ = ("ring", "count", "total")

    def __init__(self, maxlen: int = 512):
        self.ring: deque = deque(maxlen=maxlen)
        self.count = 0
        self.total = 0.0

    def observe(self, v: float) -> None:
        v = float(v)
        self.ring.append(v)
        self.count += 1
        self.total += v

    def mean(self) -> float:
        return self.total / self.count if self.count else float("nan")

    def percentile(self, q: float) -> float:
        if not self.ring:
            return float("nan")
        return float(np.percentile(np.asarray(self.ring), q))

    def summary(self) -> dict:
        return {
            "count": self.count,
            "total": self.total,
            "mean": self.mean(),
            "p50": self.percentile(50),
            "p99": self.percentile(99),
        }


class MetricsRegistry:
    """Name -> instrument map with create-on-first-use semantics."""

    def __init__(self):
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._hists: dict[str, WindowedHistogram] = {}

    # -------- instrument access --------

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter()
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge()
        return g

    def histogram(self, name: str, maxlen: int = 512) -> WindowedHistogram:
        h = self._hists.get(name)
        if h is None:
            h = self._hists[name] = WindowedHistogram(maxlen)
        return h

    # -------- convenience --------

    def inc(self, name: str, v: float = 1.0) -> float:
        return self.counter(name).inc(v)

    def set(self, name: str, v: float) -> float:
        return self.gauge(name).set(v)

    def observe(self, name: str, v: float) -> None:
        self.histogram(name).observe(v)

    def value(self, name: str) -> float:
        """Counter (or gauge) value; 0.0 for a name never touched."""
        c = self._counters.get(name)
        if c is not None:
            return c.value
        g = self._gauges.get(name)
        return g.value if g is not None else 0.0

    def counters(self, prefix: str = "") -> dict[str, float]:
        return {name: c.value for name, c in self._counters.items()
                if name.startswith(prefix)}

    def snapshot(self) -> dict:
        """Everything, as plain data (benches dump this into their JSON)."""
        return {
            "counters": {k: c.value for k, c in self._counters.items()},
            "gauges": {k: g.value for k, g in self._gauges.items()},
            "histograms": {k: h.summary() for k, h in self._hists.items()},
        }
