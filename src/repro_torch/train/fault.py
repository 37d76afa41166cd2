"""Fault tolerance for long-running jobs: auto-restart from checkpoint,
straggler detection with deadline-based mitigation, and preemption hooks.

Port of ``repro.train.fault``, which is pure Python: the same policy,
detector and restart loop.

At 1000+ node scale the failure model is: (a) hard node loss -> restart
from the last checkpoint on a (possibly resized) mesh; (b) stragglers ->
per-step deadline from a robust EWMA; steps blowing the deadline are
retried (backup execution) and repeated offenders mark the node for
eviction (fed back to the ICO scheduler as interference!).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class StragglerPolicy:
    ewma_alpha: float = 0.1
    deadline_factor: float = 3.0   # deadline = factor * ewma
    min_samples: int = 5
    evict_after: int = 3           # consecutive violations -> evict signal


class StragglerDetector:
    def __init__(self, policy: StragglerPolicy | None = None):
        self.policy = policy or StragglerPolicy()
        self.ewma: float | None = None
        self.n = 0
        self.violations = 0
        self.total_violations = 0

    def observe(self, duration: float) -> dict:
        """Record a step duration; returns {straggler, evict, deadline}."""
        p = self.policy
        out = {"straggler": False, "evict": False, "deadline": float("inf")}
        if self.ewma is None:
            self.ewma = duration
        if self.n >= p.min_samples:
            deadline = p.deadline_factor * self.ewma
            out["deadline"] = deadline
            if duration > deadline:
                out["straggler"] = True
                self.violations += 1
                self.total_violations += 1
                if self.violations >= p.evict_after:
                    out["evict"] = True
            else:
                self.violations = 0
        # robust EWMA: clip the sample so one outlier cannot poison the mean
        clipped = min(duration, 5.0 * self.ewma) if self.ewma else duration
        self.ewma = (1 - p.ewma_alpha) * self.ewma + p.ewma_alpha * clipped
        self.n += 1
        return out


class Preemptible(Exception):
    """Raised by the environment (or injected in tests) to simulate node loss."""


def run_with_restarts(
    train_loop,
    checkpointer,
    max_restarts: int = 3,
):
    """Run train_loop(start_state) with checkpoint-restart on Preemptible.

    train_loop: callable(restored_state_or_None) -> final_state; must
    checkpoint periodically via `checkpointer`.
    """
    restarts = 0
    state = None
    while True:
        try:
            return train_loop(state), restarts
        except Preemptible:
            restarts += 1
            if restarts > max_restarts:
                raise
            state = "RESTORE"  # sentinel: loop must reload from checkpointer
