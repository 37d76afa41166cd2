"""Wall-clock phase timers (a copy of ``repro.obs.timers.PhaseTimers``).

``PhaseTimers`` wraps each phase in a ``with timers.phase(name):`` block and
keeps two ledgers: lifetime totals/counts for end-of-run summaries, and a
per-window scratch dict drained with ``pop_window()``.

A phase time is host wall-clock: CUDA work is asynchronous, so a phase
that should include its device work must end in
``torch.cuda.synchronize()`` inside the block.
"""
from __future__ import annotations

import contextlib
import time


class PhaseTimers:
    """Named wall-clock accumulators with per-window drain."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        self._window: dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        start = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - start
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1
            self._window[name] = self._window.get(name, 0.0) + dt

    def pop_window(self) -> dict[str, float]:
        """Return and clear the seconds accumulated since the last pop."""
        w = self._window
        self._window = {}
        return w

    def summary(self) -> dict[str, dict]:
        """Per-phase ``{total_s, calls, mean_ms}`` over the whole run."""
        return {
            name: {
                "total_s": total,
                "calls": self.counts.get(name, 0),
                "mean_ms": 1e3 * total / max(self.counts.get(name, 0), 1),
            }
            for name, total in self.totals.items()
        }
