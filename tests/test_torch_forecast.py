"""The port's forecast slice against ``repro.control.forecast``: the
forecaster over ~100 windows, ``project_node_pressure``, the
``ForecastService`` (projection, annotation, warm start through
``convert``), ``ClusterView``'s forecast fields and ICO-F, on the same
numpy inputs; then the cases of ``tests/test_forecast.py``,
``test_view.py`` (forecast part), ``test_traces.py`` and
``test_scheduler.py`` (ICO-F part) on the port."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.cluster import ClusterView as JView
from repro.cluster import trace as jtrace
from repro.cluster.simulator import Cluster as JCluster
from repro.control import ForecastService as JService
from repro.control import QPSForecaster as JForecaster
from repro.control import project_node_pressure as jproject
from repro.core import ICOFScheduler as JICOF
from repro.core import ICOScheduler as JICO
from repro.core import InterferenceQuantifier as JQuant
from repro_torch.cluster import experiment as texp
from repro_torch.cluster import trace as ttrace
from repro_torch.cluster.state import TICKS_PER_DAY, _season
from repro_torch.cluster.view import ClusterView
from repro_torch.cluster.workloads import OFFLINE_PROFILES, Pod
from repro_torch.control import (
    DetectorConfig,
    ForecastConfig,
    ForecastService,
    QPSForecaster,
    StreamingDetector,
    project_node_pressure,
)
from repro_torch.convert import forecast_service_from_numpy, view_from_numpy
from repro_torch.core import (
    ICOFScheduler,
    ICOScheduler,
    InterferenceQuantifier,
    SchedulerConfig,
    metric,
)
from repro_torch.core.interference import INTF_NORM

CPU = torch.device("cpu")
FIT_TOL = dict(rtol=1e-5, atol=1e-5)


def _diurnal(mean, t, phase=0.3):
    w = 2 * np.pi / TICKS_PER_DAY
    return mean * (1.0 + 0.35 * np.sin(w * t + phase)
                   + 0.12 * np.sin(2 * w * t + 1.7 * phase))


# ---------------- the forecaster against JAX ----------------

def _window_stream(rng, n=5, s=4, windows=100, dt=40.0):
    """Seeded per-window (t, qps, active) with diurnal pods of different
    means and phases, noise, pods leaving and arriving, and two clears."""
    mean = rng.uniform(80, 600, (n, s))
    phase = rng.uniform(0, 2 * np.pi, (n, s))
    active = rng.uniform(size=(n, s)) < 0.8
    out = []
    for i in range(windows):
        t = 30.0 + dt * i
        qps = (_diurnal(mean, t, phase)
               * (1 + 0.04 * rng.standard_normal((n, s)))).astype(np.float32)
        if i % 17 == 16:
            flip = rng.integers(0, n), rng.integers(0, s)
            active[flip] = ~active[flip]
        clear = ([1, 3], [2, 0]) if i in (40, 77) else None
        out.append((t, qps, active.copy(), clear))
    return out


def test_forecaster_matches_jax_over_a_hundred_windows():
    rng = np.random.default_rng(5)
    stream = _window_stream(rng)
    n, s = stream[0][1].shape
    jf, tf = JForecaster(n, s), QPSForecaster(n, s, device=CPU)
    for i, (t, qps, active, clear) in enumerate(stream):
        if clear is not None:
            jf.clear_slots(*clear)
            tf.clear_slots(*clear)
        jerr = jf.update(t, qps, active)
        terr = tf.update(t, qps, active)
        np.testing.assert_allclose(terr.numpy(), jerr, **FIT_TOL)
        np.testing.assert_allclose(tf.last_pred.numpy(), jf.last_pred,
                                   rtol=1e-5, atol=1e-3)
        if i % 10 == 9 or i == len(stream) - 1:
            np.testing.assert_allclose(tf.A.numpy(), np.asarray(jf.A),
                                       **FIT_TOL)
            np.testing.assert_allclose(tf.b.numpy(), np.asarray(jf.b),
                                       rtol=1e-5, atol=1e-3)
            np.testing.assert_array_equal(tf.count.numpy(),
                                          np.asarray(jf.count))
            for h in (None, 240.0, 1500.0):
                t_fut = None if h is None else t + h
                np.testing.assert_array_equal(
                    tf.confidence(t_fut).numpy(), jf.confidence(t_fut))
            np.testing.assert_allclose(tf.forecast(t + 240.0).numpy(),
                                       jf.forecast(t + 240.0),
                                       rtol=1e-4, atol=1e-2)
    # the stream ends with open and closed gates alike
    gate = tf.confidence(stream[-1][0] + 240.0).numpy()
    assert gate.any() and not gate.all()
    assert tf.calibration_error() == pytest.approx(jf.calibration_error(),
                                                   rel=1e-5)


def _pressure_views(rng, n=6, s=4):
    on_type = rng.integers(0, 4, (n, s)).astype(np.int32)
    active = rng.uniform(size=(n, s)) < 0.7
    off = rng.uniform(0, 20, n).astype(np.float32)
    cpu_sum = rng.choice([16.0, 32.0, 96.0], n).astype(np.float32)
    jv = JView(on_type=on_type, on_active=active, off_pressure=off,
               cpu_sum=cpu_sum)
    tv = ClusterView(on_type=torch.as_tensor(on_type),
                     on_active=torch.as_tensor(active),
                     off_pressure=torch.as_tensor(off),
                     cpu_sum=torch.as_tensor(cpu_sum))
    return jv, tv


def test_project_node_pressure_matches_jax():
    rng = np.random.default_rng(3)
    jv, tv = _pressure_views(rng)
    for dtype in (np.float32, np.float64):
        qps = rng.uniform(0, 700, (6, 4)).astype(dtype)
        got = project_node_pressure(tv, torch.as_tensor(qps))
        assert got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), jproject(jv, qps),
                                   rtol=1e-12, atol=0)


def _views(t, qps, uids, hists, n, s_on, s_off=2):
    """One window as a JAX view and as the port's (float32 telemetry)."""
    jv = JView(
        t=float(t), online_qps=qps.astype(np.float32),
        on_active=uids[:, :s_on] >= 0,
        on_type=(np.arange(n * s_on).reshape(n, s_on) % 4).astype(np.int32),
        off_pressure=np.linspace(0, 12, n).astype(np.float32),
        cpu_sum=np.full(n, 32.0, np.float32), slot_hists=hists,
        slot_uids=uids, delay_base=np.full(n, 5.0),
        delay_scale=np.linspace(40, 80, n), rho_knee=np.full(n, 0.02))
    return jv, view_from_numpy(jv, device=CPU)


def _service_stream(rng, n=4, s_on=3, windows=150, dt=40.0):
    mean = rng.uniform(150, 500, (n, s_on))
    uids = np.arange(n * (s_on + 2)).reshape(n, s_on + 2)
    uids[0, 2] = -1                                   # a vacant slot
    hists = np.zeros((n, s_on + 2, metric.NUM_BINS), np.float32)
    for i in range(n):
        hists[i, 0, 4 + 2 * i] = 64.0
    out = []
    for k in range(windows):
        t = 30.0 + dt * k
        if k == 100:
            uids = uids.copy()
            uids[1, 0] = 99                           # a new tenant
        qps = _diurnal(mean, t, 0.3 + np.arange(s_on)) * (
            1 + 0.03 * rng.standard_normal((n, s_on)))
        out.append(_views(t, qps, uids, hists, n, s_on))
    return out


def _assert_projection_equal(tproj, jproj):
    np.testing.assert_array_equal(tproj.trusted.numpy(), jproj.trusted)
    for k in ("runqlat", "rho", "delta"):
        got = getattr(tproj, k)
        assert got.dtype == torch.float64, k
        np.testing.assert_allclose(got.numpy(), getattr(jproj, k),
                                   rtol=1e-4, atol=1e-3, err_msg=k)


def test_service_project_and_annotate_match_jax():
    stream = _service_stream(np.random.default_rng(9))
    jsvc, tsvc = JService(), ForecastService(device=CPU)
    opened = False
    for k, (jv, tv) in enumerate(stream):
        jsvc.observe(jv)
        tsvc.observe(tv)
        jsvc.observe(jv)   # idempotent per view.t
        tsvc.observe(tv)
        jp, tp = jsvc.project(jv), tsvc.project(tv)
        assert (jp is None) == (tp is None)
        if jp is None:
            continue
        _assert_projection_equal(tp, jp)
        opened |= bool(jp.trusted.any())
        if k % 25 == 0 or k == len(stream) - 1:
            jsvc.annotate(jv)
            tsvc.annotate(tv)
            np.testing.assert_allclose(tv.forecast_drift().numpy(),
                                       jv.forecast_drift(), rtol=1e-4,
                                       atol=1e-3)
    assert opened and tsvc._dt == jsvc._dt
    np.testing.assert_array_equal(tsvc.forecaster.count.numpy(),
                                  np.asarray(jsvc.forecaster.count))


def test_warm_start_from_a_jax_state_dict_projects_the_same():
    stream = _service_stream(np.random.default_rng(4), windows=90)
    jsvc = JService()
    for jv, _ in stream:
        jsvc.observe(jv)
    state = jsvc.state_dict()
    warm_j = JService()
    warm_j.load_state_dict(state)
    warm_t = forecast_service_from_numpy(state, device=CPU)
    assert warm_t._last_t is None and warm_t._dt == warm_j._dt
    jv, tv = stream[-1]
    jp, tp = warm_j.project(jv), warm_t.project(tv)
    assert jp.trusted.any()
    _assert_projection_equal(tp, jp)
    # both keep learning from the next window
    jv2, tv2 = _views(jv.t + 40.0, np.asarray(jv.online_qps) * 1.01,
                      jv.slot_uids, jv.slot_hists, 4, 3)
    warm_j.observe(jv2)
    warm_t.observe(tv2)
    np.testing.assert_allclose(warm_t.forecaster.A.numpy(),
                               np.asarray(warm_j.forecaster.A), **FIT_TOL)


# ---------------- ICO-F against JAX ----------------

def _scored_views(rng, n):
    hists = np.zeros((n, 2, 200), np.float32)
    hists[np.arange(n), 0, rng.integers(5, 60, n)] = 50
    off = np.zeros((n, 2, 200), np.float32)
    off[np.arange(n), 1, rng.integers(1, 30, n)] = 20
    fr = rng.uniform(-50, 400, n)
    jv = JView(
        cpu_cur=rng.uniform(1, 20, n).astype(np.float32),
        cpu_sum=np.full(n, 32.0, np.float32),
        mem_cur=rng.uniform(2, 40, n).astype(np.float32),
        mem_sum=np.full(n, 64.0, np.float32),
        online_hists=hists, offline_hists=off,
        features=rng.uniform(0, 300, (n, 45)).astype(np.float32),
        online_qps_sum=rng.uniform(100, 400, n).astype(np.float32),
        forecast_rho=np.full(n, 0.5),
        forecast_trusted=rng.uniform(size=n) < 0.6)
    jv.forecast_runqlat = np.asarray(jv.node_runqlat_avg()) + fr
    return jv, view_from_numpy(jv, device=CPU)


def _pod(cpu=2.0, mem=2.0, qps=100.0):
    p = Pod("web_search", qps, True)
    p.cpu_demand, p.mem_demand = cpu, mem
    return p


@pytest.mark.parametrize("n", [16, 200])
def test_icof_scores_match_jax(n):
    """Exact path (n <= candidate_k) and top-k path (n > candidate_k): the
    forecast fields are sliced with the candidate sub-view."""
    rng = np.random.default_rng(n)
    jv, tv = _scored_views(rng, n)
    cfg = SchedulerConfig(candidate_k=64)
    jq = JQuant(lambda X: np.asarray(X)[:, 21])
    tq = InterferenceQuantifier(lambda X: X[:, 21])
    for w_f in (1.0, 3.0):
        js, ts = JICOF(jq, cfg, w_f=w_f), ICOFScheduler(tq, cfg, w_f=w_f)
        for _ in range(3):
            pod = _pod(cpu=rng.uniform(0.5, 6), mem=rng.uniform(0.5, 8),
                       qps=rng.uniform(50, 500))
            assert ts.select_node(pod, tv) == js.select_node(pod, jv)
            got, want = ts.scores(pod, tv).numpy(), np.asarray(
                js.scores(pod, jv))
            np.testing.assert_array_equal(np.isfinite(got),
                                          np.isfinite(want))
            fin = np.isfinite(want)
            np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5,
                                       atol=1e-6)
    # the drift moved the choice somewhere: ICO and ICO-F disagree
    pod = _pod()
    ico = ICOScheduler(tq, cfg).scores(pod, tv).numpy()
    icof = ICOFScheduler(tq, cfg, w_f=50.0).scores(pod, tv).numpy()
    assert not np.allclose(ico[np.isfinite(ico)], icof[np.isfinite(icof)])


def test_take_slices_the_forecast_fields():
    _, tv = _scored_views(np.random.default_rng(1), 100)
    idx = torch.tensor([3, 50, 7])
    sub = tv.take(idx)
    for k in ("forecast_runqlat", "forecast_rho", "forecast_trusted"):
        np.testing.assert_array_equal(getattr(sub, k).numpy(),
                                      getattr(tv, k)[idx].numpy())
    np.testing.assert_allclose(sub.forecast_drift().numpy(),
                               tv.forecast_drift()[idx].numpy())


# ---------------- tests/test_forecast.py on the port ----------------

def _fit_day(noise=0.0, seed=0, dt=15.0, days=1.2, mean=400.0, phase=0.3):
    f = QPSForecaster(1, 1, device=CPU)
    rng = np.random.default_rng(seed)
    ts = np.arange(30, days * TICKS_PER_DAY, dt)
    for t in ts:
        y = _diurnal(mean, t, phase) * (1.0 + noise * rng.normal())
        f.update(t, np.array([[y]]), np.array([[True]]))
    return f, float(ts[-1])


def test_forecaster_converges_on_pure_diurnal_trace():
    f, t = _fit_day(noise=0.03)
    assert bool(f.confidence(t + 120)[0, 0])
    for h in (60.0, 120.0, 240.0):
        pred = float(f.forecast(t + h)[0, 0])
        truth = _diurnal(400.0, t + h)
        assert abs(pred - truth) / truth < 0.10
    assert f.calibration_error() < 0.10


def test_forecaster_tracks_predicted_movement_not_just_level():
    f, t = _fit_day(noise=0.02)
    fit_now = float(f.forecast(t)[0, 0])
    fit_fut = float(f.forecast(t + 240.0)[0, 0])
    truth_delta = _diurnal(400.0, t + 240.0) - _diurnal(400.0, t)
    assert abs(truth_delta) > 20
    assert np.sign(fit_fut - fit_now) == np.sign(truth_delta)
    assert abs((fit_fut - fit_now) - truth_delta) < 0.5 * abs(truth_delta)


def test_forecaster_confidence_requires_history_and_low_leverage():
    cfg = ForecastConfig()
    f = QPSForecaster(1, 1, cfg, device=CPU)
    for i in range(cfg.min_windows - 1):
        f.update(30.0 + 15.0 * i, np.array([[400.0]]), np.array([[True]]))
    assert not f.confidence()[0, 0]
    f2 = QPSForecaster(1, 1, cfg, device=CPU)
    for t in np.arange(30, 620, 15.0):
        f2.update(t, np.array([[_diurnal(400.0, t)]]), np.array([[True]]))
    assert f2.confidence()[0, 0]                   # interpolation passes...
    assert not f2.confidence(620.0 + 240.0)[0, 0]  # ...extrapolation not
    f3, t3 = _fit_day(noise=0.0)
    assert f3.confidence(t3 + 240.0)[0, 0]


def test_forecaster_determinism_across_reset():
    seq = [(30.0 + 15.0 * i,
            np.array([[300.0 + 10.0 * np.sin(i)], [500.0]]),
            np.array([[True], [i % 2 == 0]]))
           for i in range(20)]
    f = QPSForecaster(2, 1, device=CPU)
    first = [f.update(*args).clone() for args in seq]
    fc1 = f.forecast(400.0)
    f.reset()
    second = [f.update(*args).clone() for args in seq]
    fc2 = f.forecast(400.0)
    for e1, e2 in zip(first, second):
        assert torch.equal(e1, e2)
    assert torch.equal(fc1, fc2)


def test_forecaster_clear_slots_forgets_a_tenant():
    f, t = _fit_day()
    assert int(f.count[0, 0]) > 0
    f.clear_slots([0], [0])
    assert int(f.count[0, 0]) == 0 and float(f.err[0, 0]) == 1.0
    assert not f.confidence()[0, 0]
    assert float(f.forecast(t)[0, 0]) == 0.0  # an empty fit predicts nothing


def _proj_view(qps, on_type=0, off_pressure=0.0):
    n, s = qps.shape
    return ClusterView(on_type=torch.full((n, s), on_type, dtype=torch.int32),
                       on_active=torch.ones((n, s), dtype=torch.bool),
                       off_pressure=torch.full((n,), off_pressure),
                       cpu_sum=torch.full((n,), 32.0))


def test_project_node_pressure_monotone_in_qps():
    v = _proj_view(torch.full((1, 4), 300.0))
    lo = project_node_pressure(v, torch.full((1, 4), 300.0))
    hi = project_node_pressure(v, torch.full((1, 4), 600.0))
    assert hi[0] > lo[0] > 0
    off = project_node_pressure(
        _proj_view(torch.full((1, 4), 300.0), off_pressure=16.0),
        torch.full((1, 4), 300.0))
    assert float(off[0]) == pytest.approx(float(lo[0]) + 16.0 / 32.0)


def _level_hists(levels):
    """Deterministic (N, S, 200) histograms with given per-slot averages."""
    levels = np.asarray(levels, float)
    out = np.zeros((*levels.shape, metric.NUM_BINS), np.float32)
    k = np.clip((levels / metric.BIN_WIDTH).astype(int), 0,
                metric.NUM_BINS - 1)
    for idx in np.ndindex(levels.shape):
        if levels[idx] > 0:
            out[idx][k[idx]] = 64.0
    return out


def test_detector_proactive_fires_before_reactive_would():
    cfg = DetectorConfig(abs_threshold=1e9)
    with_fc = StreamingDetector(1, cfg, device=CPU)
    without = StreamingDetector(1, cfg, device=CPU)
    calm, edge = _level_hists([[20.0]]), _level_hists([[40.0]])
    for _ in range(5):
        assert not with_fc.update(calm, forecast_avg=np.array([20.0])).any()
        assert not without.update(calm).any()
    first_pro = first_hot = None
    for i in range(16):
        with_fc.update(edge, forecast_avg=np.array([150.0]))
        without.update(edge)
        if first_pro is None and with_fc.last_proactive.any():
            first_pro = i
        if first_hot is None and without.last_hot.any():
            first_hot = i
    assert first_pro is not None and first_hot is not None
    assert first_pro < first_hot


@pytest.mark.parametrize("forecast", [True, False])
def test_detector_proactive_needs_forecast_and_corroboration(forecast):
    """A model-only prediction on a calm node must not flag; nor does a hot
    node without a forecast."""
    det = StreamingDetector(1, DetectorConfig(abs_threshold=1e9), device=CPU)
    hists = _level_hists([[20.0]] if forecast else [[600.0]])
    for _ in range(10):
        det.update(hists, forecast_avg=np.array([500.0]) if forecast
                   else None)
        assert not det.last_proactive.any()


def test_detector_reactive_flag_outranks_proactive():
    det = StreamingDetector(1, DetectorConfig(abs_threshold=1e9, warmup=1),
                            device=CPU)
    det.update(_level_hists([[20.0]]), forecast_avg=np.array([20.0]))
    spike = _level_hists([[500.0]])
    for _ in range(4):
        det.update(spike, forecast_avg=np.array([900.0]))
        assert not (det.last_hot & det.last_proactive).any()
    assert det.last_hot.any() or det.last_proactive.any()


# ---------------- tests/test_view.py (forecast part) on the port --------

def test_forecast_drift_gating():
    v = ClusterView(slot_hists=torch.zeros((3, 2, metric.NUM_BINS)))
    assert v.forecast_drift() is None
    v.forecast_runqlat = torch.tensor([50.0, -10.0, 30.0], dtype=torch.float64)
    v.forecast_trusted = torch.tensor([True, True, False])
    np.testing.assert_allclose(v.forecast_drift().numpy(), [50.0, 0.0, 0.0])


def _synthetic_view(t, qps, uid=0):
    """One-node, one-pod view carrying just what the service consumes."""
    hists = torch.zeros((1, 1, metric.NUM_BINS))
    hists[0, 0, 4] = 64.0
    return ClusterView(
        t=float(t), online_qps=torch.tensor([[qps]], dtype=torch.float32),
        on_active=torch.ones((1, 1), dtype=torch.bool),
        on_type=torch.zeros((1, 1), dtype=torch.int32),
        off_pressure=torch.zeros(1), cpu_sum=torch.full((1,), 32.0),
        slot_hists=hists, slot_uids=np.full((1, 1), uid, np.int64))


def _fit_service(days=1.2, dt=15.0, mean=400.0):
    svc = ForecastService(device=CPU)
    last = None
    for t in np.arange(30.0, days * TICKS_PER_DAY, dt):
        last = _synthetic_view(t, _diurnal(mean, t))
        svc.observe(last)
    return svc, last


def test_service_projects_after_two_windows_and_annotates():
    svc = ForecastService(device=CPU)
    v0 = _synthetic_view(30.0, 400.0)
    svc.observe(v0)
    assert svc.project(v0) is None            # cadence unknown
    v1 = _synthetic_view(45.0, 402.0)
    svc.observe(v1)
    proj = svc.project(v1)
    assert proj.runqlat.shape == (1,) and torch.isfinite(proj.runqlat).all()
    assert not proj.trusted[0]
    svc.annotate(v1)
    assert v1.forecast_runqlat is not None
    np.testing.assert_allclose(v1.forecast_drift().numpy(), [0.0])


def test_service_observe_is_idempotent_per_timestamp():
    svc = ForecastService(device=CPU)
    svc.observe(_synthetic_view(30.0, 400.0))
    svc.observe(_synthetic_view(45.0, 410.0))
    A1 = svc.forecaster.A.clone()
    svc.observe(_synthetic_view(45.0, 410.0))
    assert torch.equal(svc.forecaster.A, A1)
    assert int(svc.forecaster.count[0, 0]) == 2


def test_service_clears_fit_when_tenant_changes():
    svc, last = _fit_service(days=0.3)
    assert int(svc.forecaster.count[0, 0]) > 10
    svc.observe(_synthetic_view(last.t + 15.0, 90.0, uid=7))
    assert int(svc.forecaster.count[0, 0]) == 1


def test_service_resets_on_same_shape_cluster_swap():
    svc, last = _fit_service(days=1.2)
    assert svc.project(last).trusted[0]
    state = svc.state_dict()
    svc.observe(_synthetic_view(30.0, 400.0))  # new run: clock restarted
    assert int(svc.forecaster.count[0, 0]) == 1
    assert svc.project(_synthetic_view(30.0, 400.0)) is None
    warm = ForecastService(device=CPU)
    warm.load_state_dict(state)
    warm.observe(_synthetic_view(30.0, 400.0))
    assert int(warm.forecaster.count[0, 0]) > 100


def test_service_resets_on_new_cluster_shape():
    svc, _ = _fit_service(days=0.3)
    v = ClusterView(
        t=10.0, online_qps=torch.full((2, 3), 100.0),
        on_active=torch.ones((2, 3), dtype=torch.bool),
        on_type=torch.zeros((2, 3), dtype=torch.int32),
        off_pressure=torch.zeros(2), cpu_sum=torch.full((2,), 32.0),
        slot_hists=torch.zeros((2, 6, metric.NUM_BINS)),
        slot_uids=np.zeros((2, 6), np.int64))
    svc.observe(v)
    assert tuple(svc.forecaster.A.shape[:2]) == (2, 3)
    assert svc.project(v) is None


def test_service_trusts_movement_after_a_full_period():
    svc, last = _fit_service(days=1.2)
    proj = svc.project(last)
    assert proj.trusted[0]
    t_fut = last.t + svc.horizon * svc._dt
    truth_delta = _diurnal(400.0, t_fut) - _diurnal(400.0, last.t)
    assert np.sign(float(proj.delta[0])) == np.sign(truth_delta)


def test_service_warm_start_round_trip():
    svc, last = _fit_service(days=1.2)
    warm = ForecastService(device=CPU)
    warm.load_state_dict(svc.state_dict())
    cold_proj, warm_proj = svc.project(last), warm.project(last)
    assert torch.equal(warm_proj.runqlat, cold_proj.runqlat)
    assert torch.equal(warm_proj.rho, cold_proj.rho)
    assert bool(warm_proj.trusted[0]) == bool(cold_proj.trusted[0])
    warm.observe(_synthetic_view(last.t + 15.0,
                                 _diurnal(400.0, last.t + 15.0)))
    assert int(warm.forecaster.count[0, 0]) == int(
        svc.forecaster.count[0, 0]) + 1


def test_service_state_dict_requires_fits():
    with pytest.raises(RuntimeError, match="no fits"):
        ForecastService(device=CPU).state_dict()


def test_forecast_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ForecastService()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        QPSForecaster(2, 2)


def _quantifier():
    return InterferenceQuantifier(lambda X: X[:, 21])


def _online_pod(qps=300.0, name="web_search"):
    p = Pod(name, qps, True)
    p.cpu_demand, p.mem_demand = 0.022 * qps + 0.8, 0.011 * qps + 2.0
    return p


@pytest.mark.parametrize("cold_service", [False, True])
def test_icof_stream_identical_to_ico_while_the_gate_is_shut(cold_service):
    """Without a service, or with one whose gate never opens on a short
    trace, ICO-F places as ICO does, bit for bit (a service makes the run
    windowed, so the per-window utilisation spread is not compared
    then)."""
    q = _quantifier()
    pods, gaps = texp.bursty_trace(num_online=6, num_bursts=2,
                                   jobs_per_burst=2, seed=1)
    kw = dict(num_nodes=6, seed=3, settle_ticks=10, device=CPU)
    r_ico = texp.run_experiment(ICOScheduler(q), pods, gaps, **kw)
    extra = (dict(forecast=ForecastService(device=CPU), control_window=20)
             if cold_service else {})
    r_icof = texp.run_experiment(ICOFScheduler(q), pods, gaps, **kw,
                                 **extra)
    fields = ["placed", "rejected", "p99_rt", "avg_rt"]
    for f in fields + ([] if cold_service else ["cpu_util_std"]):
        assert getattr(r_icof, f) == getattr(r_ico, f), f


# ---------------- tests/test_scheduler.py (ICO-F part) on the port ------

def _sched_view(n=4, node_runqlat=None):
    hists = torch.zeros((n, 2, 200))
    if node_runqlat is not None:
        for i, avg in enumerate(node_runqlat):
            hists[i, 0, int(avg // 5)] = 50
    return ClusterView(
        cpu_cur=torch.full((n,), 4.0), cpu_sum=torch.full((n,), 32.0),
        mem_cur=torch.full((n,), 8.0), mem_sum=torch.full((n,), 64.0),
        online_hists=hists, offline_hists=torch.zeros((n, 2, 200)),
        features=torch.ones((n, 45)),
        online_qps_sum=torch.linspace(100, 400, n))


def test_icof_matches_ico_without_forecast_annotation():
    q, pod = _quantifier(), _pod()
    data = _sched_view(4, node_runqlat=[500, 100, 900, 300])
    assert ICOFScheduler(q).select_node(pod, data) == \
        ICOScheduler(q).select_node(pod, data)
    assert torch.equal(ICOFScheduler(q).scores(pod, data),
                       ICOScheduler(q).scores(pod, data))


def test_icof_penalizes_projected_drift():
    q, pod = _quantifier(), _pod()
    data = _sched_view(4, node_runqlat=[100, 100, 100, 100])
    assert ICOScheduler(q).select_node(pod, data) == 0
    data.forecast_runqlat = data.node_runqlat_avg().double() + torch.tensor(
        [400.0, 0.0, 0.0, 0.0], dtype=torch.float64)
    data.forecast_trusted = torch.ones(4, dtype=torch.bool)
    assert ICOFScheduler(q).select_node(pod, data) != 0
    data.forecast_trusted = torch.zeros(4, dtype=torch.bool)
    assert ICOFScheduler(q).select_node(pod, data) == 0
    assert torch.equal(ICOFScheduler(q).scores(pod, data),
                       ICOScheduler(q).scores(pod, data))


def test_icof_drift_is_clamped_nonnegative():
    q, pod = _quantifier(), _pod()
    data = _sched_view(2, node_runqlat=[300, 300])
    data.forecast_runqlat = data.node_runqlat_avg().double() - 200.0
    data.forecast_trusted = torch.ones(2, dtype=torch.bool)
    assert torch.equal(ICOFScheduler(q).scores(pod, data),
                       ICOScheduler(q).scores(pod, data))


def test_icof_rejects_nonpositive_weight():
    with pytest.raises(ValueError):
        ICOFScheduler(_quantifier(), w_f=0.0)
    assert ICOFScheduler(_quantifier()).w_f * INTF_NORM > 0


# ---------------- tests/test_traces.py on the port ----------------

def test_bursty_trace_week_span_and_burst_coverage():
    pods, gaps = texp.bursty_trace(days=7, seed=3)
    assert len(pods) == len(gaps)
    arrival = np.cumsum(gaps)
    assert arrival[-1] >= 6.5 * TICKS_PER_DAY
    off_days = {int(t // TICKS_PER_DAY)
                for t, p in zip(arrival, pods) if not p.is_online}
    assert off_days >= set(range(7)), sorted(off_days)


def test_bursty_trace_days_never_shrinks_bursts():
    pods_short, _ = texp.bursty_trace(num_bursts=50, days=0.1, seed=0)
    assert sum(1 for p in pods_short if not p.is_online) >= 50 * 4


def test_diurnal_season_periodic_over_seven_days():
    t = torch.linspace(0.0, TICKS_PER_DAY, 97)
    base = _season(t, torch.tensor(0.7))
    for day in range(1, 7):
        shifted = _season(t + day * TICKS_PER_DAY, torch.tensor(0.7))
        np.testing.assert_allclose(shifted.numpy(), base.numpy(), atol=5e-3)


def test_forecaster_memory_covers_a_period():
    cfg = ForecastConfig()
    windows_per_day = TICKS_PER_DAY / 40
    assert 1.0 / (1.0 - cfg.decay) >= windows_per_day
    assert cfg.decay ** windows_per_day >= 0.5


@pytest.mark.parametrize("seed", [0, 4])
def test_qps_trace_and_arrivals_match_jax(seed):
    np.testing.assert_array_equal(ttrace.qps_trace(300.0, 3000, seed=seed),
                                  jtrace.qps_trace(300.0, 3000, seed=seed))
    np.testing.assert_array_equal(
        ttrace.poisson_arrivals(0.05, 5000, seed=seed),
        jtrace.poisson_arrivals(0.05, 5000, seed=seed))
    assert ttrace.TICKS_PER_DAY == TICKS_PER_DAY


def test_config_fields_match_jax():
    from repro.control import ForecastConfig as JConfig

    assert dataclasses.asdict(ForecastConfig()) == dataclasses.asdict(
        JConfig())


def test_view_from_a_jax_cluster_carries_forecast_fields():
    """A JAX view annotated by a JAX service converts with its float64
    projection and bool gate intact."""
    c = JCluster(num_nodes=3, seed=2)
    pod = Pod("web_search", 300.0, True)
    pod.cpu_demand, pod.mem_demand = 7.4, 5.3
    assert c.place(pod, 0)
    job = Pod("graph_analytics", 0.0, False, duration=500)
    job.cpu_demand = 8.0
    job.mem_demand = 8.0 * OFFLINE_PROFILES["graph_analytics"].mem_per_core
    assert c.place(job, 1)
    svc = JService()
    for _ in range(3):
        c.rollout(40)
        jv = c.view()
        svc.observe(jv)
    svc.annotate(jv)
    tv = view_from_numpy(jv, device=CPU)
    assert tv.forecast_runqlat.dtype == torch.float64
    assert tv.forecast_trusted.dtype == torch.bool
    np.testing.assert_array_equal(tv.forecast_runqlat.numpy(),
                                  jv.forecast_runqlat)
    np.testing.assert_allclose(tv.forecast_drift().numpy(),
                               jv.forecast_drift())
