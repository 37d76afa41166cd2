"""Closed-loop controller: detect hotspots, plan mitigations, act, verify.

Port of ``repro.control.loop`` (the reactive loop).  ``ControlLoop.step(
cluster, view=None)`` feeds the window's per-slot runqlat histograms to the
streaming detector on the cluster's device and, every ``interval``-th call
with a flagged node, asks the mitigation policy for a budgeted plan and
applies it.

The loop is verified: every applied action records its node's raw-window
average runqlat, and on the next ``step`` the observed delta is compared
with the action's ``predicted_reduction``.  A per-kind multiplicative
correction (EWMA of the clipped realized/predicted ratio, clamped to
[``corr_min``, ``corr_max``]) rescales future predictions in the greedy
ranking.  A post-action window is trusted only when the node's pod
signature -- uids AND each pod's QPS/cores -- is unchanged; otherwise the
sample is discarded.

The loop is optionally proactive: with ``proactive=True`` every step feeds
the view to a ``ForecastService`` -- one the loop owns (built on the
cluster's device), or a caller's shared instance, so that ICO-F and the
loop price contention with one projection, trust gate and ``rho_cap``.  The
projection drives the detector's forecast channel; its ``proactive`` flags
are priced at the forecast pressure, cost less, and skip post-action
verification (the window they target is still ahead).  The projection
stays on the device; the forecast pressure comes to the host in one copy,
and only in a step that plans.

With a ``recorder`` the loop emits ``HotspotFlag``, ``ActionExecuted``,
``ActionVerified`` (and, through the policy, ``ActionPlanned``) events;
``run`` also opens a window per rollout and emits ``PhaseTimings``.

``scheduler_loop_config`` maps a scheduler name to its tuned profile: ICO
and LQP keep the aggressive default; RR and HUP get a conservative,
source-relief-only one (no migrate / scale-out), under which mitigation
does not hurt their near-uniform placements.
"""
from __future__ import annotations

import dataclasses
import weakref
from collections import deque

import numpy as np
import torch

from repro_torch.control.actions import Action
from repro_torch.control.detector import DetectorConfig, StreamingDetector
from repro_torch.control.forecast import ForecastConfig, ForecastService
from repro_torch.control.policy import MitigationPolicy, PolicyConfig
from repro_torch.device import sync
from repro_torch.obs import (
    ActionExecuted,
    ActionVerified,
    HotspotFlag,
    MetricsRegistry,
    PhaseTimers,
    PhaseTimings,
)


@dataclasses.dataclass(frozen=True)
class ControlLoopConfig:
    interval: int = 1      # act on every interval-th step() call
    cooldown: int = 2      # steps a node is left alone after being acted on
    uid_cooldown: int = 4  # steps a pod is left alone after being acted on
    corr_beta: float = 0.35  # EWMA rate of the per-kind calibration factor
    corr_min: float = 0.4    # calibration clamp: demote an over-promising
                             # kind at most 2.5x (post-action windows are
                             # noisy; one sample must not bury a kind)
    corr_max: float = 2.0    # ... nor credit it more than 2x
    proactive: bool = False  # forecast channel + ahead-of-time mitigation
    horizon: float = 6.0     # telemetry windows ahead to project
    history_limit: int = 512  # ring-buffer bound on ControlLoop.history
    detector: DetectorConfig = dataclasses.field(
        default_factory=DetectorConfig)
    policy: PolicyConfig = dataclasses.field(default_factory=PolicyConfig)
    forecast: ForecastConfig = dataclasses.field(
        default_factory=ForecastConfig)


@dataclasses.dataclass
class ControlStats:
    """Snapshot view over the loop's metrics registry."""

    steps: int = 0
    hotspots_flagged: int = 0
    proactive_flagged: int = 0   # forecast-channel flags
    actions_planned: int = 0
    actions_applied: int = 0
    proactive_applied: int = 0   # subset of applied planned ahead of time
    actions_verified: int = 0
    verifications_discarded: int = 0  # post-action windows too churned
    predicted_reduction: float = 0.0  # sum of predictions of verified
    realized_reduction: float = 0.0   # sum of observed post-action deltas
    calibration_abs_error: float = 0.0  # sum |realized - predicted|
    by_kind: dict = dataclasses.field(default_factory=dict)

    def calibration_error(self) -> float:
        """Mean relative |realized - predicted| error of the cost model."""
        return self.calibration_abs_error / max(self.predicted_reduction, 1e-9)

    @property
    def mean_calibration_abs_error(self) -> float:
        """Mean |realized - predicted| per verified action (0.0 with
        nothing verified)."""
        return self.calibration_abs_error / max(self.actions_verified, 1)


class ControlLoop:
    """Runtime interference-mitigation controller for one cluster."""

    def __init__(self, quantifier, config: ControlLoopConfig | None = None,
                 forecast_service=None, recorder=None):
        self.cfg = config or ControlLoopConfig()
        self.policy = MitigationPolicy(quantifier, self.cfg.policy)
        self.metrics = MetricsRegistry()
        self.timers = PhaseTimers()
        self.history: deque[dict] = deque(maxlen=self.cfg.history_limit)
        # per-kind calibration of predicted_reduction (1.0 = trust model)
        self.corrections: dict[str, float] = {}
        # a caller's service is shared (e.g. with ICO-F) and survives
        # reset(); its own config and horizon govern the projection
        self._external_forecast = forecast_service
        self._recorder = recorder
        self.reset()

    @property
    def stats(self) -> ControlStats:
        v = self.metrics.value
        return ControlStats(
            steps=int(v("steps")),
            hotspots_flagged=int(v("hotspots_flagged")),
            proactive_flagged=int(v("proactive_flagged")),
            actions_planned=int(v("actions_planned")),
            actions_applied=int(v("actions_applied")),
            proactive_applied=int(v("proactive_applied")),
            actions_verified=int(v("actions_verified")),
            verifications_discarded=int(v("verifications_discarded")),
            predicted_reduction=v("predicted_reduction"),
            realized_reduction=v("realized_reduction"),
            calibration_abs_error=v("calibration_abs_error"),
            by_kind={name[len("applied_kind."):]: int(c) for name, c
                     in self.metrics.counters("applied_kind.").items()},
        )

    @property
    def recorder(self):
        return self._recorder

    @recorder.setter
    def recorder(self, rec) -> None:
        self._recorder = rec
        # an internally owned service traces into the same sink; a shared
        # one belongs to its owner, who wires it
        if self._external_forecast is None and \
                self.forecast_service is not None:
            self.forecast_service.recorder = rec

    def reset(self) -> None:
        """Forget per-cluster state: detector, cooldowns, pending checks.

        Called when ``step`` sees a new cluster object.  Learned
        ``corrections`` and cumulative ``stats`` / ``history`` survive:
        calibration belongs to the cost model, not to one cluster.  An
        internally owned forecast service is rebuilt at the next ``step``
        (on that cluster's device); a shared one is left to its owner.
        """
        self.detector: StreamingDetector | None = None
        self.forecast_service: ForecastService | None = \
            self._external_forecast
        self._cluster_ref = lambda: None
        self._last_acted: dict[int, int] = {}      # node -> step acted
        self._uid_last_acted: dict[int, int] = {}  # pod uid -> step
        self._pending: dict[int, int] = {}         # hot node -> step flagged
        self._pending_pro: dict[int, int] = {}     # forecast-flagged
        self._to_verify: list[Action] = []         # applied last step
        self._verify_sig: dict[int, frozenset] = {}  # node -> pod signature
        self._slot_uids: np.ndarray | None = None  # last (N, S) tenants

    @property
    def forecaster(self):
        """The service's per-pod fits (None while the channel is off)."""
        svc = self.forecast_service
        return svc.forecaster if svc is not None else None

    @staticmethod
    def _node_signature(cluster, node: int) -> frozenset:
        """Pod set AND per-pod load parameters of a node: uid diffs catch
        arrivals and departures, the QPS/cores catch renormalisation (a
        scale-out halves its source's QPS with the uid set unchanged)."""
        return frozenset(
            (p["uid"], round(float(p.get("qps", p.get("cores", 0.0))), 6))
            for p in cluster.pods_on_node(node)
        )

    def _verify(self, cluster, window_avg: np.ndarray) -> list[dict]:
        """Compare last step's actions with the runqlat observed since.

        A node's delta is shared among its actions in proportion to their
        predictions; each action's kind correction moves toward its clipped
        realized/predicted ratio.  A node whose pod signature changed is
        discarded: its delta measures the churn, not the action.
        """
        verified: list[dict] = []
        if not self._to_verify:
            return verified
        cfg = self.cfg
        m = self.metrics
        rec = self._recorder
        by_node: dict[int, list[Action]] = {}
        for a in self._to_verify:
            by_node.setdefault(a.node, []).append(a)
        for node, acts in by_node.items():
            if self._node_signature(cluster, node) != \
                    self._verify_sig.get(node):
                m.inc("verifications_discarded", len(acts))
                if rec:
                    for a in acts:
                        rec.emit(ActionVerified(
                            action=a.kind, action_id=a.action_id, node=node,
                            outcome="discarded",
                            predicted=a.predicted_reduction,
                            reason="signature_changed"))
                continue
            delta = float(acts[0].pre_runqlat - window_avg[node])
            total_pred = sum(a.predicted_reduction for a in acts)
            for a in acts:
                share = a.predicted_reduction / max(total_pred, 1e-9)
                a.realized_reduction = delta * share
                ratio = float(np.clip(
                    a.realized_reduction / max(a.predicted_reduction, 1e-9),
                    0.0, cfg.corr_max))
                old = self.corrections.get(a.kind, 1.0)
                self.corrections[a.kind] = float(np.clip(
                    (1.0 - cfg.corr_beta) * old + cfg.corr_beta * ratio,
                    cfg.corr_min, cfg.corr_max))
                m.inc("actions_verified")
                m.inc("predicted_reduction", a.predicted_reduction)
                m.inc("realized_reduction", a.realized_reduction)
                m.inc("calibration_abs_error",
                      abs(a.realized_reduction - a.predicted_reduction))
                if rec:
                    rec.emit(ActionVerified(
                        action=a.kind, action_id=a.action_id, node=node,
                        outcome="verified", predicted=a.predicted_reduction,
                        realized=a.realized_reduction,
                        correction=self.corrections[a.kind]))
                verified.append({
                    "node": node, "kind": a.kind,
                    "predicted": a.predicted_reduction,
                    "realized": a.realized_reduction,
                    "correction": self.corrections[a.kind],
                })
        self._to_verify = []
        self._verify_sig = {}
        return verified

    def _reconcile_slot_tenants(self, view) -> None:
        """Clear the detector's attribution for slots whose tenant changed
        since the last step (place / migrate / evict reuse slots)."""
        if view.slot_uids is None:
            return
        uids = np.asarray(view.slot_uids)
        prev, self._slot_uids = self._slot_uids, uids
        if prev is None or prev.shape != uids.shape:
            return
        nodes, slots = np.nonzero(uids != prev)
        if nodes.size:
            self.detector.clear_slots(nodes, slots)

    def _forecast(self, view):
        """Project each node's runqlat ``horizon`` windows ahead.

        Feeds the service this window's view (idempotent if the driver
        already did) and turns its projection into the detector's forecast
        input: nodes the model says get meaningfully worse get the
        projected runqlat, the rest the no-forecast sentinel.  Returns
        ``(None, None)`` while the channel is off or not warmed up, else
        (forecast input, forecast pressure) as float64 device tensors.
        """
        svc = self.forecast_service
        if not self.cfg.proactive or svc is None or view.online_qps is None:
            return None, None
        svc.observe(view)
        proj = svc.project(view)
        if proj is None:
            return None, None  # two windows are needed for the cadence
        forecast_avg = torch.where(
            proj.delta >= svc.cfg.min_predicted_drift, proj.runqlat, -1e9)
        return forecast_avg, proj.rho

    def step(self, cluster, view=None) -> list[Action]:
        """One control iteration; returns the actions actually applied.

        ``view``: the ``ClusterView`` of the window that just ended (a
        driver that built one passes it; otherwise the loop snapshots the
        cluster).
        """
        if (self.detector is None or self.detector.n != cluster.n
                or self._cluster_ref() is not cluster):
            self.reset()
            self.detector = StreamingDetector(cluster.n, self.cfg.detector,
                                              device=cluster.device)
            if self.forecast_service is None and self.cfg.proactive:
                self.forecast_service = ForecastService(
                    self.cfg.forecast, self.cfg.horizon,
                    device=cluster.device)
                self.forecast_service.recorder = self._recorder
            self._cluster_ref = weakref.ref(cluster)
        if view is None:
            view = cluster.view()
        slot_hists = view.slot_hists
        if slot_hists is None:
            slot_hists = torch.cat([view.online_hists, view.offline_hists], 1)
        # clear reused slots BEFORE this window's update, so a new tenant's
        # first histogram scores as an arrival, not as its predecessor's
        self._reconcile_slot_tenants(view)
        # raw last-window node average (not the decayed estimate):
        # verification compares like with like across adjacent windows
        window_avg = view.node_runqlat_avg().cpu().numpy()
        with self.timers.phase("verify"):
            verified = self._verify(cluster, window_avg)
        with self.timers.phase("forecast"):
            forecast_avg, forecast_rho = self._forecast(view)
        with self.timers.phase("detect"):
            hot = self.detector.update(slot_hists, forecast_avg)
        pro = self.detector.last_proactive
        m = self.metrics
        rec = self._recorder
        step_no = int(m.inc("steps"))
        m.inc("hotspots_flagged", int(hot.sum()))
        m.inc("proactive_flagged", int(pro.sum()))
        if rec and (hot.any() or pro.any()):
            self._emit_hotspots(hot, pro)

        # flags stay pending for one acting interval, so interval > 1 cannot
        # lose them; flags raised during a node's cooldown expire.  A
        # reactive flag outranks a pending proactive one
        for node in np.nonzero(hot)[0]:
            self._pending[int(node)] = step_no
            self._pending_pro.pop(int(node), None)
        for node in np.nonzero(pro)[0]:
            if int(node) not in self._pending:
                self._pending_pro[int(node)] = step_no
        keep = lambda d: {n: s for n, s in d.items()  # noqa: E731
                          if step_no - s < self.cfg.interval}
        self._pending = keep(self._pending)
        self._pending_pro = keep(self._pending_pro)

        # a freshly mitigated node gets cooldown steps for its telemetry to
        # reflect the action before more mitigations pile on
        actionable = np.zeros(cluster.n, bool)
        actionable[list(self._pending)] = True
        actionable[list(self._pending_pro)] = True
        for node, step in self._last_acted.items():
            if step_no - step < self.cfg.cooldown:
                actionable[node] = False
        proactive_mask = np.zeros(cluster.n, bool)
        proactive_mask[list(self._pending_pro)] = True
        proactive_mask &= actionable

        applied: list[Action] = []
        if actionable.any() and step_no % self.cfg.interval == 0:
            recently_acted = frozenset(
                uid for uid, step in self._uid_last_acted.items()
                if step_no - step < self.cfg.uid_cooldown
            )
            # the policy reads the forecast pressure of proactive nodes
            # only: one copy to the host, and only when there are some
            pressure = (forecast_rho.cpu().numpy()
                        if forecast_rho is not None and proactive_mask.any()
                        else None)
            with self.timers.phase("plan"):
                plan = self.policy.plan(
                    cluster, view, actionable, exclude_uids=recently_acted,
                    corrections=self.corrections,
                    attribution=self.detector.attribution(),
                    proactive=proactive_mask, forecast_pressure=pressure,
                    recorder=rec)
            m.inc("actions_planned", len(plan))
            for action in plan:
                if not action.apply(cluster):
                    continue
                applied.append(action)
                action.pre_runqlat = float(window_avg[action.node])
                if action.proactive:
                    # no post-window check: the window it mitigates is
                    # horizon steps ahead, and next window's delta would
                    # poison the per-kind corrections
                    m.inc("proactive_applied")
                else:
                    self._to_verify.append(action)
                m.inc("actions_applied")
                m.inc(f"applied_kind.{action.kind}")
                if not action.proactive:
                    # proactive actions skip the node cooldown: if the
                    # incident still develops, the reactive track must be
                    # free to respond (uid_cooldown prevents ping-pong)
                    self._last_acted[action.node] = step_no
                self._pending.pop(action.node, None)
                self._pending_pro.pop(action.node, None)
                uid = getattr(action, "uid", -1)
                if uid >= 0:
                    self._uid_last_acted[uid] = step_no
                if rec:
                    rec.emit(ActionExecuted(
                        action=action.kind, action_id=action.action_id,
                        node=action.node, uid=uid,
                        dst=getattr(action, "dst", -1),
                        proactive=action.proactive,
                        pre_runqlat=action.pre_runqlat,
                        predicted_reduction=action.predicted_reduction))
            for node in {a.node for a in applied if not a.proactive}:
                self._verify_sig[node] = self._node_signature(cluster, node)
        if hot.any() or pro.any() or applied or verified:
            self.history.append({
                "step": step_no,
                "window": rec.window if rec else step_no - 1,
                "t": float(view.t),
                "hot_nodes": np.nonzero(hot)[0].tolist(),
                "proactive_nodes": np.nonzero(pro)[0].tolist(),
                "hot_slots": self.detector.hot_slots(),
                "applied": [a.describe() for a in applied],
                "verified": verified,
            })
        return applied

    def _emit_hotspots(self, hot: np.ndarray, pro: np.ndarray) -> None:
        """One HotspotFlag per flagged node from the detector's host
        diagnostics (``cusum`` / ``f_cusum`` are the pre-consumption trip
        values: a flag zeroes the live accumulators)."""
        rec = self._recorder
        diag = self.detector.last_diag
        slots = self.detector.hot_slots()
        scores = self.detector.slot_scores
        for node in np.nonzero(hot | pro)[0]:
            node = int(node)
            if pro[node]:
                channel = "forecast"
            elif diag["drift_hot"][node]:
                channel = "drift"
            else:
                channel = "acute"
            slot = slots.get(node, -1)
            rec.emit(HotspotFlag(
                node=node, channel=channel,
                avg=float(diag["avg"][node]), mu=float(diag["mu"][node]),
                p_tail=float(diag["p_tail"][node]),
                cusum=float(diag["cusum_trip"][node]),
                f_cusum=float(diag["f_cusum_trip"][node]),
                slot=slot,
                slot_score=float(scores[node, slot]) if slot >= 0 else 0.0,
            ))

    def run(self, cluster, num_ticks: int, k: int | None = None
            ) -> ControlStats:
        """Interleave rollout and control every ~k ticks (standalone).

        Progress is read from the cluster's clock (rollout rounds up to
        CHUNK multiples); a rollout that advances it by zero ticks raises
        instead of spinning forever.  With a recorder, each rollout opens a
        telemetry window and the window's phase times are emitted.
        """
        k = k or cluster.CHUNK
        done = 0
        rec = self._recorder
        while done < num_ticks:
            t0 = cluster.t
            with self.timers.phase("rollout"):
                cluster.rollout(min(k, num_ticks - done))
                sync(cluster.device)
            progress = int(cluster.t - t0)
            if progress <= 0:
                raise RuntimeError(
                    f"cluster.rollout made no progress at t={cluster.t!r} "
                    f"({done}/{num_ticks} ticks done): refusing to spin "
                    f"forever -- check num_ticks vs the cluster's chunking")
            done += progress
            if rec:
                rec.begin_window(cluster.t)
            self.step(cluster)
            tw = self.timers.pop_window()
            if rec and tw:
                rec.emit(PhaseTimings(timings=tw))
        return self.stats


# Per-scheduler control profiles.  The default guards were tuned against
# ICO placements, which concentrate headroom by design; under RR's uniform
# spread and HUP's utilisation packing, destination actions chase seasonal
# troughs across near-symmetric nodes and p99 ends up worse than without
# mitigation on some seeds.  Their profiles demand more evidence (drift
# threshold), cool pods down longer, spend a smaller budget, and keep only
# source-side relief (evict / throttle).
SCHEDULER_PROFILES: dict[str, ControlLoopConfig] = {
    "ICO": ControlLoopConfig(),
    # ICO-F is ICO until the forecast gate opens: ICO's profile
    "ICO-F": ControlLoopConfig(),
    "LQP": ControlLoopConfig(),
    "RR": ControlLoopConfig(
        uid_cooldown=8,
        detector=DetectorConfig(drift_threshold=90.0),
        policy=PolicyConfig(budget=8.0, cost_weight=1.5,
                            destination_actions=False),
    ),
    "HUP": ControlLoopConfig(
        uid_cooldown=8,
        detector=DetectorConfig(drift_threshold=120.0),
        policy=PolicyConfig(budget=6.0, cost_weight=2.0,
                            destination_actions=False),
    ),
}


def scheduler_loop_config(scheduler: str,
                          proactive: bool = False) -> ControlLoopConfig:
    """Tuned ControlLoopConfig for a scheduler (default for unknown names);
    ``proactive=True`` asks for the forecast channel on top of it."""
    cfg = SCHEDULER_PROFILES.get(scheduler, ControlLoopConfig())
    if proactive:
        cfg = dataclasses.replace(cfg, proactive=True)
    return cfg
