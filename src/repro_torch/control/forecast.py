"""Online seasonal QPS forecaster driving proactive mitigation.

Port of ``repro.control.forecast``.  Every pod keeps a decayed
least-squares regression of its window-mean QPS onto diurnal harmonics

    x(t) = [1, sin wt, cos wt, sin 2wt, cos 2wt],   w = 2*pi / TICKS_PER_DAY

with moments A = sum decay^k x x^T and b = sum decay^k x y.
``_forecast_update`` scores the previous fit at time t, then folds in the
observation, for all (node, slot) pods in one batch of tensor operations;
the batched replay folds the same function into its window loop.

*Confidence gate* -- a pod's forecast is trusted after ``min_windows``
observations, while the EWMA of its one-step relative error stays under
``max_rel_err``, and while the leverage x'(A + ridge I)^-1 x of the
forecast time stays under ``max_leverage`` (the one-step error cannot see
an extrapolation into a direction the observed arc has not pinned down).
An untrusted pod contributes its current QPS to a projection.

*Projection* -- ``project_node_pressure`` pushes per-slot QPS through the
linear resource model, in float64 from the view's float32 fields as the
JAX package's numpy does, and the delay curve maps the pressure to node
runqlat.

*Service* -- ``ForecastService`` owns the forecaster, the telemetry
cadence, the tenant-keyed fit invalidation and the projection
``y(t) + fit(t+h) - fit(t)``.  The mitigation loop and ICO-F consume one
instance.  The fits live on the service's device, and ``project`` reads
nothing back to the host, except the gate state behind a trace
recorder's ``TrustGateTransition`` events.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.cluster.state import OS_BASE_CORES, TICKS_PER_DAY
from repro_torch.cluster.workloads import online_arrays
from repro_torch.control.policy import view_delay_params
from repro_torch.device import resolve_device

NUM_FEATURES = 5  # [1, sin wt, cos wt, sin 2wt, cos 2wt]
_OMEGA = 2.0 * math.pi / TICKS_PER_DAY


@dataclasses.dataclass(frozen=True)
class ForecastConfig:
    decay: float = 0.995      # per-window decay of the regression moments;
                              # the memory must span a diurnal period
    ridge: float = 1.0        # Tikhonov term on the normal-equation solve
    err_alpha: float = 0.3    # EWMA rate of the one-step relative error
    min_windows: int = 6      # observations before a pod's fit is trusted
    max_rel_err: float = 0.25  # confidence gate on the one-step rel. error
    qps_floor: float = 25.0   # rel-error denominator floor (QPS units)
    max_leverage: float = 0.1  # extrapolation guard: x' (A + ridge I)^-1 x
                               # at the forecast time
    rho_cap: float = 0.85     # ceiling on the forecast pressure: near the
                              # delay curve's asymptote a few percent of
                              # QPS error becomes phantom drift
    min_predicted_drift: float = 3.0  # projected runqlat increase under
                                      # which a node's forecast is withheld
                                      # from the proactive channel


def _features(t: torch.Tensor) -> torch.Tensor:
    """(..., F) harmonic features of a float32 time tensor."""
    wt = _OMEGA * t
    return torch.stack([torch.ones_like(wt), torch.sin(wt), torch.cos(wt),
                        torch.sin(2.0 * wt), torch.cos(2.0 * wt)], dim=-1)


def _solve(A: torch.Tensor, b: torch.Tensor, ridge: float) -> torch.Tensor:
    """Batched ridge solve of (A + ridge I) w = b.  ``solve_ex`` does not
    check the factorisation on the host, so the card is never synchronised;
    A + ridge I is positive definite for ridge > 0."""
    eye = torch.eye(NUM_FEATURES, dtype=A.dtype, device=A.device)
    return torch.linalg.solve_ex(A + ridge * eye, b[..., None]).result[..., 0]


def _f32(t: float, device) -> torch.Tensor:
    return torch.tensor(t, dtype=torch.float32, device=device)


def _forecast_update(A, b, err, count, t, y, active, decay, ridge, alpha,
                     qps_floor):
    """Score the previous fit at time t, then fold in the new observation.

    A (R, S, F, F), b (R, S, F), err / count (R, S); ``t`` a 0-d float32
    tensor; y (R, S) window-mean QPS, active (R, S) bool.  Returns the new
    state plus the one-step prediction the old fit made for this window.
    """
    x = _features(t)                                   # (F,)
    pred = torch.clamp_min((_solve(A, b, ridge) * x).sum(-1), 0.0)
    rel = (pred - y).abs() / torch.clamp_min(y, qps_floor)
    scored = active & (count > 0)
    err = torch.where(scored, (1.0 - alpha) * err + alpha * rel, err)
    xx = x[:, None] * x[None, :]
    A = torch.where(active[..., None, None], decay * A + xx, A)
    b = torch.where(active[..., None], decay * b + x * y[..., None], b)
    count = torch.where(active, count + 1, count)
    return A, b, err, count, pred


def _forecast_eval(A, b, t_future, ridge):
    """Per-pod QPS the fits give at ``t_future`` (0-d float32 tensor)."""
    x = _features(t_future)
    return torch.clamp_min((_solve(A, b, ridge) * x).sum(-1), 0.0)


def _leverage(A, t_future, ridge):
    """x' (A + ridge I)^-1 x at the forecast time, batched over (N, S)."""
    xb = _features(t_future).expand(A.shape[:-2] + (NUM_FEATURES,))
    return (xb * _solve(A, xb, ridge)).sum(-1)


class QPSForecaster:
    """Per-(node, slot) forecast state as tensors on ``device`` (``None``
    -> the CUDA card)."""

    def __init__(self, num_nodes: int, num_slots: int,
                 config: ForecastConfig | None = None, *, device=None):
        self.cfg = config or ForecastConfig()
        self.n = num_nodes
        self.s = num_slots
        self.device = resolve_device(device)
        self.reset()

    def reset(self) -> None:
        F, dev = NUM_FEATURES, self.device
        self.A = torch.zeros((self.n, self.s, F, F), dtype=torch.float32,
                             device=dev)
        self.b = torch.zeros((self.n, self.s, F), dtype=torch.float32,
                             device=dev)
        # err starts at 1.0 (untrusted) and must be earned down through
        # min_windows good one-step predictions
        self.err = torch.ones((self.n, self.s), dtype=torch.float32,
                              device=dev)
        self.count = torch.zeros((self.n, self.s), dtype=torch.int32,
                                 device=dev)
        self.last_pred: torch.Tensor | None = None

    def clear_slots(self, nodes, slots) -> None:
        """Forget a slot's fit: its tenant changed."""
        nodes = np.asarray(nodes, np.int64).ravel()
        slots = np.asarray(slots, np.int64).ravel()
        if nodes.size == 0:
            return
        idx = (torch.as_tensor(nodes, device=self.device),
               torch.as_tensor(slots, device=self.device))
        self.A[idx] = 0.0
        self.b[idx] = 0.0
        self.err[idx] = 1.0
        self.count[idx] = 0

    def update(self, t: float, qps, active) -> torch.Tensor:
        """Feed one window's mean QPS; returns the one-step EWMA errors."""
        c = self.cfg
        qps = torch.as_tensor(qps, dtype=torch.float32, device=self.device)
        active = torch.as_tensor(active, dtype=torch.bool, device=self.device)
        self.A, self.b, self.err, self.count, self.last_pred = \
            _forecast_update(self.A, self.b, self.err, self.count,
                             _f32(t, self.device), qps, active, c.decay,
                             c.ridge, c.err_alpha, c.qps_floor)
        return self.err

    def forecast(self, t_future: float) -> torch.Tensor:
        """Per-pod QPS the harmonic fits project at a future tick time."""
        return _forecast_eval(self.A, self.b, _f32(t_future, self.device),
                              self.cfg.ridge)

    def confidence(self, t_future: float | None = None) -> torch.Tensor:
        """(N, S) bool: pods whose forecast passes the confidence gate; with
        ``t_future`` also the leverage gate at that time."""
        c = self.cfg
        ok = (self.count >= c.min_windows) & (self.err <= c.max_rel_err)
        if t_future is not None:
            lev = _leverage(self.A, _f32(t_future, self.device),
                            self.cfg.ridge)
            ok = ok & (lev <= self.cfg.max_leverage)
        return ok

    def calibration_error(self) -> float:
        """Mean one-step relative error over pods with enough history."""
        mature = self.count >= self.cfg.min_windows
        if not bool(mature.any()):
            return float("nan")
        return float(self.err[mature].mean())


_PROFILES64: dict = {}


def _profile64(device: torch.device) -> dict:
    """The online profiles' float32 resource-model columns, widened to
    float64 tensors on ``device`` (cached)."""
    key = str(device)
    if key not in _PROFILES64:
        arrs = online_arrays()
        _PROFILES64[key] = {
            k: torch.as_tensor(arrs[k].astype(np.float64), device=device)
            for k in ("cpu_per_qps", "cpu_base")}
    return _PROFILES64[key]


def project_node_pressure(view, qps) -> torch.Tensor:
    """(N,) float64 burst-weighted run-queue pressure each node would carry
    at the given per-slot online QPS (offline pressure from the current
    window), on the device of ``qps``.

    As JAX's numpy: the float32 profile columns and view fields are widened
    to float64, never rebuilt from Python floats.
    """
    dev = qps.device
    arrs = _profile64(dev)
    on_type = view.on_type.to(dev).long()
    cpu_on = torch.where(
        view.on_active.to(dev),
        arrs["cpu_per_qps"][on_type] * qps.double()
        + arrs["cpu_base"][on_type],
        0.0)
    pressure = cpu_on.sum(-1) + view.off_pressure.to(dev).double() \
        + OS_BASE_CORES
    return pressure / view.cpu_sum.to(dev).double()


def delay_curve(rho: torch.Tensor, base, scale, knee) -> torch.Tensor:
    """``policy.node_delay_curve`` on float64 tensors (rho ** 2 as one
    product, as numpy computes it)."""
    return base + scale * (rho * rho) / torch.clamp_min(1.0 - rho, knee)


@dataclasses.dataclass
class NodeProjection:
    """Per-node runqlat projection at the service horizon (tensors on the
    service's device)."""

    runqlat: torch.Tensor   # (N,) float64 observed avg runqlat + delta
    rho: torch.Tensor       # (N,) float64 forecast pressure, <= rho_cap
    delta: torch.Tensor     # (N,) float64 delay(rho_fut) - delay(rho_now)
    trusted: torch.Tensor   # (N,) bool: >= 1 pod on the node passed the gate


class ForecastService:
    """Shared seasonal-projection service for mitigation and admission.

    One ``QPSForecaster`` plus the telemetry cadence (EWMA of ticks per
    window, to turn the ``horizon`` from windows into ticks), tenant-keyed
    fit invalidation (diffing consecutive ``slot_uids``) and the
    bias-cancelling projection ``y(t) + fit(t+h) - fit(t)`` pushed through
    the delay curve.  The mitigation loop feeds its projection to the
    detector's forecast channel; ``ICOFScheduler`` reads the same projection
    off views that ``annotate`` filled.

    ``observe`` is idempotent per ``view.t`` and resets the service when the
    telemetry shape changes or the clock runs backwards (another cluster).
    ``state_dict`` / ``load_state_dict`` warm-start a later run from a prior
    run's fits.  ``device=None`` -> the CUDA card.
    """

    def __init__(self, config: ForecastConfig | None = None,
                 horizon: float = 6.0, *, device=None):
        self.cfg = config or ForecastConfig()
        self.horizon = float(horizon)
        self.device = resolve_device(device)
        self.recorder = None  # optional TraceRecorder; survives reset()
        self.reset()

    def reset(self) -> None:
        self.forecaster: QPSForecaster | None = None
        self._slot_uids: np.ndarray | None = None  # last online-slot tenants
        self._last_t: float | None = None          # clock at last observe
        self._dt: float | None = None              # EWMA ticks per window
        self._trust_prev: np.ndarray | None = None  # node gate state at the
        self._trust_emit_t: float | None = None     # last traced projection

    def clear_slots(self, nodes, slots) -> None:
        """Forget fits for (node, online-slot) pairs whose tenant changed."""
        if self.forecaster is not None:
            self.forecaster.clear_slots(nodes, slots)

    def observe(self, view) -> None:
        """Fold one telemetry window's per-pod QPS into the fits.

        Idempotent per ``view.t``; a slot whose tenant changed since the
        last window (``slot_uids``) starts a fresh fit.  A shape change or a
        backwards clock (a new cluster, whose uids restart too) resets the
        service: carrying fits into a new run is ``load_state_dict``'s job.
        """
        qps = view.online_qps
        t = float(view.t)
        shape = tuple(qps.shape)
        f = self.forecaster
        if f is not None and ((f.n, f.s) != shape or (
                self._last_t is not None and t < self._last_t)):
            self.reset()
        if self.forecaster is None:
            self.forecaster = QPSForecaster(shape[0], shape[1], self.cfg,
                                            device=self.device)
        if self._last_t is not None and t == self._last_t:
            return
        if view.slot_uids is not None:
            uids = np.asarray(view.slot_uids)[:, : shape[1]]
            prev, self._slot_uids = self._slot_uids, uids
            if prev is not None and prev.shape == uids.shape:
                nodes, slots = np.nonzero(uids != prev)
                if nodes.size:
                    self.forecaster.clear_slots(nodes, slots)
        self.forecaster.update(t, qps, view.on_active)
        if self._last_t is not None and t > self._last_t:
            dt = t - self._last_t
            self._dt = dt if self._dt is None else 0.5 * self._dt + 0.5 * dt
        self._last_t = t

    def project(self, view) -> NodeProjection | None:
        """Project node runqlat ``horizon`` windows ahead of ``view.t``.

        Differencing the fit against itself at t and t+h and applying the
        move to the observed QPS cancels the ridge/decay shrinkage bias;
        pods failing the gates keep their current QPS.  ``None`` while the
        channel is closed (no fits, or the cadence not yet known).
        """
        if self.forecaster is None or self._dt is None:
            return None
        cfg, f, dev = self.cfg, self.forecaster, self.device
        qps_now = view.online_qps.to(dev)
        t = float(view.t)
        t_fut = t + self.horizon * self._dt
        fit_now = f.forecast(t)
        fit_fut = f.forecast(t_fut)
        trusted = f.confidence(t_fut) & view.on_active.to(dev)
        qps_fut = torch.where(
            trusted, torch.clamp_min(qps_now + fit_fut - fit_now, 0.0),
            qps_now)
        rho_fut = torch.clamp_max(project_node_pressure(view, qps_fut),
                                  cfg.rho_cap)
        # per-node machine-class curve: relief on a big node and a small
        # node differ even at equal rho
        base, scale, knee = (torch.as_tensor(p, device=dev)
                             for p in view_delay_params(view))
        delta = (delay_curve(rho_fut, base, scale, knee)
                 - delay_curve(project_node_pressure(view, qps_now),
                               base, scale, knee))
        node_trusted = trusted.any(-1)
        if self.recorder and (self._trust_emit_t is None
                              or t != self._trust_emit_t):
            # one transition scan per cluster time: the loop and ICO-F's
            # annotate may both project the same window
            self._emit_trust_transitions(node_trusted, trusted, t_fut)
            self._trust_emit_t = t
        return NodeProjection(runqlat=view.node_runqlat_avg().to(dev) + delta,
                              rho=rho_fut, delta=delta, trusted=node_trusted)

    def _emit_trust_transitions(self, node_trusted, trusted, t_fut) -> None:
        """A TrustGateTransition per node whose gate just flipped (the gate
        state comes to the host in one copy)."""
        from repro_torch.control.detector import to_host
        from repro_torch.obs import TrustGateTransition

        f = self.forecaster
        lev = _leverage(f.A, _f32(t_fut, self.device), self.cfg.ridge)
        host = to_host({"node": node_trusted, "slots": trusted, "lev": lev,
                        "err": f.err, "count": f.count})
        node = host["node"]
        prev, self._trust_prev = self._trust_prev, node.copy()
        if prev is None or prev.shape != node.shape:
            return  # first projection (or after a reset): the baseline
        for n in np.nonzero(node != prev)[0]:
            n = int(n)
            seen = host["count"][n] > 0  # slots with any fit history
            self.recorder.emit(TrustGateTransition(
                node=n, opened=bool(node[n]),
                leverage=(float(host["lev"][n][seen].min()) if seen.any()
                          else np.nan),
                rel_err=(float(host["err"][n][seen].min()) if seen.any()
                         else np.nan),
                trusted_slots=int(host["slots"][n].sum()),
            ))

    def annotate(self, view):
        """Fill the view's forecast fields in place (no-op while closed)."""
        proj = self.project(view)
        if proj is not None:
            view.forecast_runqlat = proj.runqlat
            view.forecast_rho = proj.rho
            view.forecast_trusted = proj.trusted
        return view

    # -------- warm start --------

    def state_dict(self) -> dict:
        """Portable numpy snapshot of the fits, in the JAX package's keys."""
        if self.forecaster is None:
            raise RuntimeError(
                "no fits to save: observe() at least one window first")
        f = self.forecaster
        return {"A": f.A.cpu().numpy(), "b": f.b.cpu().numpy(),
                "err": f.err.cpu().numpy(), "count": f.count.cpu().numpy(),
                "last_t": self._last_t, "dt": self._dt}

    def load_state_dict(self, state: dict) -> None:
        """Adopt a prior run's fits (same workload layout assumed); the
        gates pass at once instead of being re-earned over ~a period.
        ``_last_t`` is not restored: the new run's clock starts near zero,
        and a remembered time would read as a cluster swap."""
        A = np.asarray(state["A"])
        f = QPSForecaster(A.shape[0], A.shape[1], self.cfg,
                          device=self.device)
        for k, dt in (("A", torch.float32), ("b", torch.float32),
                      ("err", torch.float32), ("count", torch.int32)):
            setattr(f, k, torch.tensor(np.asarray(state[k]), dtype=dt,
                                       device=self.device))
        self.forecaster = f
        self._slot_uids = None
        self._last_t = None
        self._dt = None if state.get("dt") is None else float(state["dt"])
