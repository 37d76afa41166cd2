"""The port's decision-trace recorder against ``repro.obs``: a traced
12-node unified run (ICO-F admission and the proactive loop sharing one
``ForecastService``), JAX's draws injected, equals JAX's run and its event
stream event for event (``PhaseTimings`` left out: wall-clock); a trace
saved by the port loads in both readers and ``explain`` prints the same
text; then the cases of ``tests/test_obs.py`` on the port.

The forecast config widens the leverage gate (``max_leverage`` 1.0) so
that the trust gate opens within this half-day trace; the default gate
needs ~0.9 of a diurnal period of data.  Both packages run the same
config.
"""
import dataclasses
import math
import time
from collections import Counter as TallyCounter

import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.cluster import experiment as jexp
from repro.control import ControlLoop as JLoop
from repro.control import ForecastConfig as JForecastConfig
from repro.control import ForecastService as JService
from repro.control import scheduler_loop_config as jprofile
from repro.core import ICOFScheduler as JICOF
from repro.core import InterferenceQuantifier as JQuant
from repro.obs import explain as jexplain
from repro_torch.cluster import experiment as texp
from repro_torch.cluster.simulator import Cluster
from repro_torch.cluster.workloads import OFFLINE_PROFILES, Pod
from repro_torch.control import (
    ControlLoop,
    ControlLoopConfig,
    ForecastConfig,
    ForecastService,
    PolicyConfig,
    scheduler_loop_config,
)
from repro_torch.core import ICOFScheduler, ICOScheduler, InterferenceQuantifier
from repro_torch.obs import (
    NULL_RECORDER,
    AdmissionDecision,
    Trace,
    TraceRecorder,
    WindowedHistogram,
    event_from_dict,
    explain,
    load_trace,
)
from test_torch_noise import jax_noise_stream

CPU = torch.device("cpu")
NODES, SIM_SEED, WINDOW = 12, 3, 40
OPEN_GATE = dict(max_leverage=1.0)
EVENT_TOL = dict(rel=1e-4, abs=2e-6)   # events hold floats rounded to 6 dp


def _trace():
    return jexp.bursty_trace(num_online=14, seed=3, burst_gap=(40, 70),
                             days=0.5)


def _jax_unified(recorder):
    q = JQuant(lambda X: np.full(np.asarray(X).shape[0], 0.1))
    cfg = dataclasses.replace(jprofile("ICO-F", proactive=True),
                              forecast=JForecastConfig(**OPEN_GATE))
    svc = JService(cfg.forecast, cfg.horizon)
    loop = JLoop(q, cfg, forecast_service=svc)
    pods, gaps = _trace()
    res = jexp.run_experiment(JICOF(q), pods, gaps, num_nodes=NODES,
                              seed=SIM_SEED, control_loop=loop, forecast=svc,
                              control_window=WINDOW, recorder=recorder)
    return res, loop


def _port_unified(recorder):
    q = InterferenceQuantifier(lambda X: torch.full((X.shape[0],), 0.1))
    cfg = dataclasses.replace(scheduler_loop_config("ICO-F", proactive=True),
                              forecast=ForecastConfig(**OPEN_GATE))
    svc = ForecastService(cfg.forecast, cfg.horizon, device=CPU)
    loop = ControlLoop(q, cfg, forecast_service=svc)
    pods, gaps = _trace()
    res = texp.run_experiment(ICOFScheduler(q), pods, gaps, num_nodes=NODES,
                              seed=SIM_SEED, control_loop=loop, forecast=svc,
                              control_window=WINDOW, recorder=recorder,
                              device=CPU,
                              noise=jax_noise_stream(SIM_SEED, NODES))
    return res, loop


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """JAX's and the port's traced unified runs, both traces saved."""
    d = tmp_path_factory.mktemp("obs")
    jrec, trec = jobs.TraceRecorder(), TraceRecorder()
    jres, jloop = _jax_unified(jrec)
    tres, tloop = _port_unified(trec)
    jpath, tpath = str(d / "jax.jsonl"), str(d / "port.jsonl")
    return {"jax": (jres, jloop, jrec, jrec.save(jpath), jpath),
            "port": (tres, tloop, trec, trec.save(tpath), tpath)}


def test_traced_unified_run_matches_jax(traced):
    jres, jloop, _, _, _ = traced["jax"]
    tres, tloop, _, _, _ = traced["port"]
    for f in ("placed", "rejected", "queued_retries", "mitigations",
              "proactive_mitigations"):
        assert getattr(tres, f) == getattr(jres, f), f
    for f in ("avg_rt", "p90_rt", "p99_rt", "predicted_reduction",
              "realized_reduction"):
        assert getattr(tres, f) == pytest.approx(getattr(jres, f),
                                                 rel=1e-4), f
    js, ts = jloop.stats, tloop.stats
    for f in ("steps", "hotspots_flagged", "proactive_flagged",
              "actions_applied", "proactive_applied", "actions_verified",
              "verifications_discarded", "by_kind"):
        assert getattr(ts, f) == getattr(js, f), f
    assert ts.proactive_applied > 0 and ts.proactive_flagged > 0
    assert tloop.forecaster.calibration_error() == pytest.approx(
        jloop.forecaster.calibration_error(), rel=1e-4)


def _same(a, b, path):
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (path, a, b)
        for k in a:
            _same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, float) or isinstance(b, float):
        if math.isnan(a):
            assert math.isnan(b), path
        elif math.isinf(a):
            assert a == b, path
        else:
            assert b == pytest.approx(a, **EVENT_TOL), path
    else:
        assert a == b, (path, a, b)


def test_traced_events_match_jax_event_for_event(traced):
    jev = [e.to_dict() for e in traced["jax"][2].events
           if type(e).event != "phase_timings"]
    tev = [e.to_dict() for e in traced["port"][2].events
           if type(e).event != "phase_timings"]
    assert len(tev) == len(jev) > 0
    for i, (a, b) in enumerate(zip(jev, tev)):
        _same(a, b, f"event {i} ({a['event']})")
    kinds = TallyCounter(e["event"] for e in tev)
    for kind in ("admission", "hotspot", "action_planned", "action_executed",
                 "action_verified", "trust_gate", "retry_drained"):
        assert kinds[kind] > 0, kind


def test_port_trace_loads_in_both_readers_and_explains_alike(traced):
    _, _, trec, saved, tpath = traced["port"]
    mine, theirs = load_trace(tpath), jobs.load_trace(tpath)
    assert saved == len(mine) == len(theirs) == len(trec)
    assert ([type(e).event for e in mine.events]
            == [type(e).event for e in theirs.events])
    uid = mine.query("admission", placed=True)[-1].uid
    aid = mine.query("action_executed", proactive=True)[0].action_id
    assert explain.summarize(mine) == jexplain.summarize(theirs)
    assert explain.explain_pod(mine, uid) == jexplain.explain_pod(theirs, uid)
    assert (explain.explain_action(mine, aid)
            == jexplain.explain_action(theirs, aid))
    assert explain.trust_history(mine) == jexplain.trust_history(theirs)
    # and JAX's own trace reads back in the port's reader
    jtrace = load_trace(traced["jax"][4])
    assert explain.summarize(jtrace) == explain.summarize(mine)


# ---------------- tests/test_obs.py on the port ----------------

def test_trace_round_trip_counts(traced):
    _, _, rec, saved, path = traced["port"]
    trace = load_trace(path)
    assert saved == len(rec.events) == len(trace.events) > 0
    live = TallyCounter(type(ev).event for ev in rec.events)
    assert live == TallyCounter(type(ev).event for ev in trace.events)
    assert live["phase_timings"] > 0
    seqs = [ev.seq for ev in trace.events]
    assert seqs == sorted(seqs) and len(set(seqs)) == len(seqs)
    windows = [ev.window for ev in trace.events]
    assert windows == sorted(windows)


def _chain_check(trace):
    executed = [c for c in explain.action_chains(trace)
                if c["executed"] is not None]
    last_w = trace.last_window()
    planned = [c["action_id"] for c in executed if c["planned"] is None]
    verified = [c["action_id"] for c in executed
                if not c["executed"].proactive
                and c["executed"].window < last_w and c["verified"] is None]
    return len(executed), planned, verified


def test_every_executed_action_resolves(traced):
    trace = load_trace(traced["port"][4])
    executed, missing_planned, missing_verified = _chain_check(trace)
    assert executed > 0 and not missing_planned and not missing_verified
    for ev in trace.query("action_executed"):
        chain = trace.action_chain(ev.action_id)
        assert chain["planned"].node == ev.node
        assert chain["planned"].window == ev.window
        if chain["verified"] is not None:
            assert chain["verified"].window > ev.window
            assert chain["verified"].outcome in ("verified", "discarded")


def test_stats_agree_with_trace(traced):
    res = traced["port"][0]
    trace = load_trace(traced["port"][4])
    assert res.mitigations == len(trace.query("action_executed"))
    assert res.proactive_mitigations == len(
        trace.query("action_executed", proactive=True))
    assert res.placed == len(trace.query("admission", placed=True))
    assert res.queued_retries == len(
        trace.query("retry_drained", outcome="placed"))


def test_admission_breakdown_reproduces_score(traced):
    trace = load_trace(traced["port"][4])
    admissions = [ev for ev in trace.query("admission")
                  if "score" in ev.breakdown]
    assert admissions
    gated = 0
    for ev in admissions:
        bd = ev.breakdown
        ucpu, umem = np.asarray(bd["utiliz_cpu"]), np.asarray(bd["utiliz_mem"])
        recomputed = ((1.0 - ucpu) * (1.0 - umem)
                      - np.asarray(bd["intf_h"]) - np.asarray(bd["intf_p"]))
        if "forecast_term" in bd:
            recomputed = recomputed - np.asarray(bd["forecast_term"])
            gated += np.asarray(bd["forecast_term"]).any()
        score = np.asarray(bd["score"], np.float64)
        feasible = np.asarray(bd["feasible"], bool)
        assert np.allclose(recomputed[feasible], score[feasible], atol=1e-3)
        assert not np.isfinite(score[~feasible]).any()
        if ev.chosen >= 0:
            assert score[ev.chosen] >= score.max() - 1e-5
    assert gated > 0, "no admission priced an open-gate forecast term"


def test_trust_gate_and_hotspot_events(traced):
    trace = load_trace(traced["port"][4])
    opened = [ev for ev in trace.query("trust_gate") if ev.opened]
    assert opened
    for ev in opened:
        assert ev.trusted_slots > 0 and ev.leverage == ev.leverage
    channels = {ev.channel for ev in trace.query("hotspot")}
    assert channels <= {"drift", "acute", "forecast"}
    assert "forecast" in channels


def test_phase_timings_recorded(traced):
    tms = traced["port"][2].query("phase_timings")
    phases = set()
    for ev in tms:
        phases |= set(ev.timings)
        assert all(s >= 0.0 for s in ev.timings.values())
    assert {"rollout", "snapshot", "detect", "forecast"} <= phases


def test_explain_cli_on_the_port_trace(traced, capsys):
    trace, path = load_trace(traced["port"][4]), traced["port"][4]
    uid = trace.query("admission", placed=True)[0].uid
    aid = trace.query("action_executed")[0].action_id
    text = explain.explain_pod(trace, uid)
    assert f"uid={uid}" in text and "utiliz_cpu" in text
    assert "planned:" in explain.explain_action(trace, aid)
    for args in (["--summary"], ["--pod", str(uid)], ["--action", str(aid)],
                 ["--trust"]):
        assert explain.main([path, *args]) == 0
    assert "admissions" in capsys.readouterr().out


def test_in_memory_trace_matches_loaded_explain(traced):
    rec, path = traced["port"][2], traced["port"][4]
    trace = load_trace(path)
    uid = trace.query("admission", placed=True)[0].uid
    live = explain.explain_pod(Trace(rec.events), uid)
    loaded = explain.explain_pod(trace, uid)
    assert live.splitlines()[0] == loaded.splitlines()[0]
    assert len(live.splitlines()) == len(loaded.splitlines())


def _cheap_quantifier():
    return InterferenceQuantifier(lambda X: torch.full((X.shape[0],), 0.1))


def _short_run(recorder, scheduler=None):
    q = _cheap_quantifier()
    pods, gaps = texp.bursty_trace(num_online=8, num_bursts=2,
                                   jobs_per_burst=3, seed=5,
                                   burst_gap=(20, 30), job_duration=(60, 100))
    return texp.run_experiment(
        scheduler or ICOScheduler(q), pods, gaps, num_nodes=5, seed=5,
        control_loop=ControlLoop(q, ControlLoopConfig(proactive=True)),
        control_window=20, recorder=recorder, device=CPU)


def test_recorder_off_bit_identical():
    """Tracing only observes: recorder on, off and null give the same run,
    every float bit for bit."""
    r_off = _short_run(None)
    rec = TraceRecorder()
    r_on = _short_run(rec)
    r_null = _short_run(NULL_RECORDER)
    assert r_on == r_off and r_null == r_off
    assert len(rec.events) > 0 and len(NULL_RECORDER) == 0


class _CheapPredictor:
    @staticmethod
    def predict(X):
        return X[:, 21]


@pytest.mark.parametrize("name", ["RR", "HUP", "LQP"])
def test_baseline_admissions_are_traced(name):
    sched = texp.make_schedulers(_CheapPredictor())[name]
    rec = TraceRecorder()
    t0 = time.time()
    res = _short_run(rec, sched)
    assert time.time() - t0 < 30.0
    admissions = rec.query("admission")
    assert admissions and all(ev.placed is not None for ev in admissions)
    assert all(ev.scheduler == name for ev in admissions)
    assert res.placed == len(rec.query("admission", placed=True))
    assert sched.recorder is None   # restored on exit
    key = {"RR": "rotation_start", "HUP": "score", "LQP": "online_qps_sum"}
    assert all(key[name] in ev.breakdown for ev in admissions)


def test_event_dict_round_trip():
    ev = AdmissionDecision(scheduler="ICO", workload="web_search", qps=220.0,
                           online=True, cpu_demand=5.0, mem_demand=4.0,
                           chosen=2, uid=7, placed=True,
                           breakdown={"score": np.array([0.1, -np.inf, 0.3]),
                                      "feasible": np.array([True, False,
                                                            True])})
    ev.seq, ev.window, ev.t = 3, 1, 40.0
    back = event_from_dict(ev.to_dict())
    assert isinstance(back, AdmissionDecision)
    assert back.chosen == 2 and back.uid == 7 and back.placed is True
    assert back.breakdown["score"] == [0.1, -np.inf, 0.3]
    assert (back.seq, back.window, back.t) == (3, 1, 40.0)
    odd = event_from_dict({"event": "from_the_future", "seq": 9, "zap": 1})
    assert type(odd).event == "generic" and odd.seq == 9
    assert odd.to_dict() == jobs.event_from_dict(
        {"event": "from_the_future", "seq": 9, "zap": 1}).to_dict()


def test_resolve_admission_binds_latest_unresolved():
    rec = TraceRecorder()
    rec.begin_window(0.0)
    rec.emit(AdmissionDecision(scheduler="ICO", chosen=1))
    rec.resolve_admission(uid=11, placed=True)
    rec.emit(AdmissionDecision(scheduler="ICO", chosen=-1))
    rec.resolve_admission(uid=-1, placed=False, retry=True)
    first, second = rec.query("admission")
    assert (first.uid, first.placed, first.retry) == (11, True, False)
    assert (second.uid, second.placed, second.retry) == (-1, False, True)
    rec.resolve_admission(uid=99, placed=True)
    assert rec.query("admission", uid=99) == []


def test_event_types_match_jax():
    from repro_torch.obs import EVENT_TYPES

    assert set(EVENT_TYPES) == set(jobs.EVENT_TYPES)
    for name, cls in EVENT_TYPES.items():
        jcls = jobs.EVENT_TYPES[name]
        assert ([(f.name, f.type) for f in dataclasses.fields(cls)]
                == [(f.name, f.type) for f in dataclasses.fields(jcls)])
        assert cls().to_dict() == jcls().to_dict()


def test_windowed_histogram_ring_is_bounded():
    h = WindowedHistogram(maxlen=8)
    for v in range(100):
        h.observe(float(v))
    assert len(h.ring) == 8 and h.count == 100
    assert h.mean() == sum(range(100)) / 100
    assert h.percentile(50) == 95.5


def test_control_stats_is_computed_view():
    loop = ControlLoop(_cheap_quantifier())
    m = loop.metrics
    m.inc("actions_applied")
    m.inc("proactive_applied")
    m.inc("proactive_flagged", 2)
    m.inc("applied_kind.migrate_online")
    s = loop.stats
    assert (s.actions_applied, s.proactive_applied, s.proactive_flagged) \
        == (1, 1, 2)
    assert s.by_kind == {"migrate_online": 1}
    assert s.mean_calibration_abs_error == 0.0
    m.inc("actions_verified", 2)
    m.inc("calibration_abs_error", 30.0)
    m.inc("predicted_reduction", 120.0)
    s = loop.stats
    assert s.mean_calibration_abs_error == pytest.approx(15.0)
    assert s.calibration_error() == pytest.approx(30.0 / 120.0)
    s.actions_applied = 99
    assert loop.stats.actions_applied == 1


def test_history_window_follows_the_recorder():
    """Without a recorder a history entry's window is its step - 1; with
    one it is the recorder's window (``run`` opens one per rollout)."""
    cfg = ControlLoopConfig(history_limit=3, policy=PolicyConfig(budget=0.0))
    for rec in (None, TraceRecorder()):
        loop = ControlLoop(_cheap_quantifier(), cfg, recorder=rec)
        cluster = Cluster(num_nodes=3, seed=0, device=CPU)
        cluster.rollout(20)
        prof = OFFLINE_PROFILES["graph_analytics"]
        for _ in range(3):
            job = Pod("graph_analytics", 0.0, False, duration=800)
            job.cpu_demand, job.mem_demand = 12.0, 12.0 * prof.mem_per_core
            assert cluster.place(job, 0)
        if rec is not None:
            rec.begin_window(cluster.t)   # run() opens one per rollout
        loop.run(cluster, num_ticks=100, k=10)
        assert len(loop.history) == 3
        for h in loop.history:
            want = h["step"] - 1 if rec is None else h["step"]
            assert h["window"] == want
        if rec is not None:
            assert rec.query("hotspot") and rec.query("phase_timings")
