"""The port's reactive control plane against ``repro.control``: detector,
actions, policy, loop and the controlled ``run_experiment``, with JAX's
tick draws injected where the simulator runs; then the cases of
``tests/test_control.py`` that hold the control-plane invariants, on the
port."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.cluster import experiment as jexp
from repro.cluster.dataset import generate_latency_dataset as jdata
from repro.cluster.simulator import Cluster as JCluster
from repro.control import ControlLoop as JLoop
from repro.control import ForecastConfig as JForecastConfig
from repro.control import MitigationPolicy as JPolicy
from repro.control import StreamingDetector as JDetector
from repro.control import scheduler_loop_config as jprofile
from repro.core.baselines import RoundRobinScheduler as JRR
from repro.core.interference import InterferenceQuantifier as JQuant
from repro.core.predictors.forest import RandomForestRegressor as JForest
from repro.core.scheduler import ICOScheduler as JICO
from repro_torch.cluster import experiment as texp
from repro_torch.cluster.simulator import S_ON, Cluster
from repro_torch.cluster.workloads import OFFLINE_PROFILES, ONLINE_PROFILES, Pod
from repro_torch.control import (
    SCHEDULER_PROFILES,
    ControlLoop,
    ControlLoopConfig,
    ControlStats,
    DetectorConfig,
    EvictOffline,
    ForecastConfig,
    ForecastService,
    MigrateOnline,
    MitigationPolicy,
    PolicyConfig,
    ScaleOut,
    StreamingDetector,
    VerticalResize,
    scheduler_loop_config,
)
from repro_torch.convert import detector_from_numpy, forest_from_numpy
from repro_torch.core import metric
from repro_torch.core.baselines import RoundRobinScheduler as TRR
from repro_torch.core.interference import InterferenceQuantifier
from repro_torch.core.scheduler import ICOFScheduler
from repro_torch.core.scheduler import ICOScheduler as TICO
from repro_torch.obs import PhaseTimers, TraceRecorder
from test_torch_noise import assert_state_equal, jax_noise_stream


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the module's tests: under the suite's
    several worker processes, torch's default of one thread a core in each
    makes their small CPU kernels spin against each other, and alone on an
    8-core CPU the module took 65 s at one thread against 72 s at eight."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def forests():
    X, y = jdata(num_placements=40, num_nodes=6, seed=2)
    jrf = JForest(n_estimators=8, max_depth=6, seed=2).fit(X, y)
    return jrf, forest_from_numpy(jrf, device=CPU)


def _cheap_quantifier():
    # predicted pod runqlat := the node's current runqlat_avg feature
    return InterferenceQuantifier(lambda X: X[:, 21])


def _online_pod(qps=300.0, name="web_search"):
    p = Pod(name, qps, True)
    prof = ONLINE_PROFILES[name]
    p.cpu_demand = prof.cpu_per_qps * qps + prof.cpu_base
    p.mem_demand = prof.mem_per_qps * qps + prof.mem_base
    return p


def _offline_pod(cores=12.0, duration=500, name="graph_analytics"):
    p = Pod(name, 0.0, False, duration=duration)
    p.cpu_demand = cores
    p.mem_demand = cores * OFFLINE_PROFILES[name].mem_per_core
    return p


def _cluster(num_nodes=2, seed=0):
    return Cluster(num_nodes=num_nodes, seed=seed, device=CPU)


def _overloaded_cluster(seed=5, num_nodes=4):
    c = _cluster(num_nodes, seed)
    assert c.place(_online_pod(400.0), 0)
    for _ in range(3):
        assert c.place(_offline_pod(12.0, duration=2000), 0)
    c.rollout(10)
    return c


def _hists(level, rng, n=64):
    """(len(level), 200) histograms of gamma samples at the given means."""
    level = np.asarray(level, np.float64)
    samples = rng.gamma(2.0, level[:, None] / 2.0, (level.size, n))
    return np.stack([np.histogram(s, bins=200, range=(0, 1000))[0]
                     for s in samples]).astype(np.float32)


def _slot_hists(levels, rng):
    return np.stack([_hists(row, rng) for row in levels])


# ---------------- detector ----------------

def _detector_inputs(rng, steps=30, n=6, s=14):
    """Seeded (N, S, 200) windows with a slot arrival, an acute tail, a
    slow drift and a forecast-only node; forecasts on some steps."""
    base = rng.uniform(10, 40, (n, s))
    base[:, 10:] = 0.0
    out = []
    for i in range(steps):
        lv = base * rng.uniform(0.9, 1.1, base.shape)
        if i >= 8:
            lv[1, 11] = 500.0                      # an arrival lands
            lv[1, :8] *= 2.0
        if i >= 12:
            lv[4, 2] = 900.0                       # acute tail
        if i >= 15:
            lv[3, :10] = base[3, :10] * 1.8        # slow drift
        fc = None
        if i % 3 == 0:
            fc = np.full(n, -1e9, np.float32)
            fc[3] = 400.0 if i >= 15 else 20.0
            fc[5] = 300.0
        out.append((_slot_hists(lv, rng), fc))
    return out


def test_detector_matches_jax_over_thirty_updates():
    rng = np.random.default_rng(0)
    cfg = DetectorConfig()
    jd = JDetector(6)
    td = StreamingDetector(6, cfg, device=CPU)
    flagged = proactive = 0
    for hists, fc in _detector_inputs(rng):
        jhot = jd.update(hists, fc)
        thot = td.update(hists, fc)
        jdiag, tdiag = jd.last_diag, td.last_diag
        assert set(tdiag) == set(jdiag)
        for k in jdiag:
            np.testing.assert_allclose(tdiag[k], np.asarray(jdiag[k]),
                                       rtol=1e-5, atol=1e-5, err_msg=k)
        # masks exact wherever the tripping statistic clears its threshold
        clear = ((np.abs(jdiag["cusum_trip"] - cfg.drift_threshold) > 1e-4)
                 & (np.abs(jdiag["p_tail"] - cfg.abs_threshold) > 1e-4)
                 & (np.abs(jdiag["f_cusum_trip"] - cfg.proactive_threshold)
                    > 1e-4))
        np.testing.assert_array_equal(thot[clear], jhot[clear])
        np.testing.assert_array_equal(td.last_proactive[clear],
                                      jd.last_proactive[clear])
        assert td.hot_slots() == jd.hot_slots()
        np.testing.assert_array_equal(td.attribution() > 0,
                                      jd.attribution() > 0)
        np.testing.assert_allclose(td.attribution(), jd.attribution(),
                                   rtol=1e-5, atol=1e-5)
        flagged += int(thot.sum())
        proactive += int(td.last_proactive.sum())
    assert flagged > 3 and proactive > 0
    assert td.steps == int(jd.steps) == 30


def test_converted_detector_continues_as_jax():
    rng = np.random.default_rng(1)
    inputs = _detector_inputs(rng, steps=20)
    jd = JDetector(6)
    for hists, fc in inputs[:12]:
        jd.update(hists, fc)
    td = detector_from_numpy(jd, device=CPU)
    assert td.hot_slots() == jd.hot_slots()
    jd.clear_slots([1], [11])
    td.clear_slots([1], [11])
    for hists, fc in inputs[12:]:
        np.testing.assert_array_equal(td.update(hists, fc),
                                      jd.update(hists, fc))
        np.testing.assert_allclose(td.slot_scores, jd.slot_scores,
                                   rtol=1e-5, atol=1e-5)


def test_detector_flags_step_in_runqlat():
    rng = np.random.default_rng(0)
    det = StreamingDetector(4, device=CPU)
    for _ in range(6):
        assert not det.update(_hists([20.0, 25.0, 15.0, 22.0], rng)).any()
    flagged = np.zeros(4, bool)
    for _ in range(4):
        flagged |= det.update(_hists([20.0, 600.0, 15.0, 22.0], rng))
    assert flagged[1] and not flagged[[0, 2, 3]].any()


def test_detector_warmup_consumes_cusum():
    rng = np.random.default_rng(3)
    det = StreamingDetector(1, DetectorConfig(warmup=3, abs_threshold=1e9),
                            device=CPU)
    det.update(_hists([20.0], rng))
    det.update(_hists([120.0], rng))
    det.update(_hists([120.0], rng))
    for _ in range(3):
        assert not det.update(_hists([20.0], rng)).any()


def test_detector_per_slot_attribution_and_clear():
    rng = np.random.default_rng(7)
    det = StreamingDetector(2, device=CPU)
    calm = [[30.0, 30.0, 0.0], [25.0, 25.0, 0.0]]
    for _ in range(5):
        assert not det.update(_slot_hists(calm, rng)).any()
    flagged = np.zeros(2, bool)
    for _ in range(4):
        hot = det.update(_slot_hists([[80.0, 80.0, 600.0],
                                      [25.0, 25.0, 0.0]], rng))
        if hot.any():
            assert det.hot_slots() == {0: 2}
        flagged |= hot
    assert flagged[0] and not flagged[1]
    assert det.slot_scores[0, 2] > det.slot_scores[0, :2].max()
    det.clear_slots([0], [2])
    assert det.slot_scores[0, 2] == 0.0
    assert float(det.slot_score[0, 2]) == 0.0


def test_attribution_floor_names_no_culprit():
    """Invariant: an acute flag with no drift attributes nothing rather
    than an argmax over noise."""
    det = StreamingDetector(1, DetectorConfig(abs_threshold=300.0),
                            device=CPU)
    hists = np.zeros((1, 2, metric.NUM_BINS), np.float32)
    hists[0, 0, 120] = 64.0
    flagged = False
    for _ in range(12):
        flagged |= bool(det.update(hists).any())
    assert flagged and det.last_hot.any()
    assert det.slot_scores.max() < det.cfg.attribution_floor
    assert det.hot_slots() == {}
    assert not det.attribution().any()


def test_detector_determinism_across_reset():
    rng = np.random.default_rng(11)
    seq = [_slot_hists([[20.0, 0.0], [30.0, 400.0]], rng) for _ in range(6)]
    det = StreamingDetector(2, device=CPU)
    first = [(det.update(h).copy(), det.slot_scores.copy()) for h in seq]
    det.reset()
    second = [(det.update(h).copy(), det.slot_scores.copy()) for h in seq]
    for (h1, s1), (h2, s2) in zip(first, second):
        np.testing.assert_array_equal(h1, h2)
        np.testing.assert_array_equal(s1, s2)


def test_detector_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StreamingDetector(3)


# ---------------- the shell's control primitives ----------------

def _load_alike(clusters, num_nodes):
    """Place the same pods, in the same order, on a JAX cluster and its
    port copy (the same numpy generator draws phases and bursts)."""
    rng = np.random.default_rng(1)
    for node in range(num_nodes - 1):
        for _ in range(int(rng.integers(1, 4))):
            qps = float(rng.uniform(200, 900))
            name = str(rng.choice(list(ONLINE_PROFILES)))
            for c in clusters:
                assert c.place(_online_pod(qps, name), node)
        for _ in range(int(rng.integers(0, 4)) if node else 3):
            cores = float(rng.choice([4.0, 8.0, 12.0]))
            for c in clusters:
                assert c.place(_offline_pod(cores, 400), node)


def _pair(num_nodes=5, seed=5):
    j = JCluster(num_nodes=num_nodes, seed=seed)
    t = Cluster(num_nodes=num_nodes, seed=seed, device=CPU,
                noise=jax_noise_stream(seed, num_nodes))
    _load_alike((j, t), num_nodes)
    j.rollout(20)
    t.rollout(20)
    return j, t


def test_pods_on_node_and_counts_match_jax():
    j, t = _pair()
    for node in range(j.n):
        assert t.pods_on_node(node) == j.pods_on_node(node)
    assert t.active_pod_count() == j.active_pod_count()
    np.testing.assert_array_equal(t.slot_uids(), j.slot_uids())


def test_view_control_methods_match_jax():
    from repro_torch.cluster.fleet import make_fleet
    j, t = _pair()
    np.testing.assert_allclose(t.view().node_runqlat_avg().numpy(),
                               j.view().node_runqlat_avg(), rtol=1e-5)
    v = t.view()
    assert (v.zone_of(3), v.migrate_cost_factor(0, 3, 2.0)) == (0, 1.0)
    assert v.transfer_cost(0, 3, 2.0) == j.view().transfer_cost(0, 3, 2.0)
    fleet = make_fleet(40, {"std32": 1, "hi96": 1}, seed=0)
    fv = Cluster(fleet=fleet, seed=0, device=CPU).view()
    assert fleet.node_class(3) is fleet.classes[3]
    assert fv.zone_of(39) == fleet.topology.zone_of(39)
    assert fv.migrate_cost_factor(0, 39, 4.0) > 1.0


def test_migrate_resize_and_reconcile_primitives():
    c = _cluster(3)
    on, off = _online_pod(400.0), _offline_pod(8.0)
    assert c.place(on, 0) and c.place(off, 0)
    before = c.active_pod_count()
    assert c.migrate(on.uid, 1) and c.active_pod_count() == before
    assert not c.state.on_active[0].any()
    assert c.migrate(off.uid, 2)
    assert float(c.state.off_cores[0].sum()) == 0.0
    assert c.resize(off.uid, cores=4.0)
    assert c.pods_on_node(2)[0]["cores"] == pytest.approx(4.0)
    with pytest.raises(KeyError):
        c.migrate(999, 1)


# ---------------- actions and policy against JAX ----------------

def _plan_tuple(a):
    return (a.kind, a.uid, a.node, getattr(a, "dst", -1))


@pytest.mark.parametrize("hot,proactive", [((0,), ()), ((0, 2), ()),
                                           ((0, 2), (2,))])
def test_policy_plan_and_apply_match_jax(hot, proactive, forests):
    """The same candidates, ranking and choice on both packages (a node
    flagged proactively is priced at its forecast pressure, its actions
    discounted and tagged); applying the plan leaves the same tenants and
    the same state."""
    jrf, trf = forests
    j, t = _pair()
    mask = np.zeros(j.n, bool)
    mask[list(hot)] = True
    pro = np.zeros(j.n, bool)
    pro[list(proactive)] = True
    kw = dict(attribution=np.zeros((j.n, 14)),
              corrections={"evict_offline": 0.8}, proactive=pro,
              forecast_pressure=np.full(j.n, 0.95))
    kw["attribution"][0, S_ON] = 40.0           # the first offline job
    cfg = PolicyConfig(budget=20.0, max_actions_per_node=3,
                       migrate_margin=0.0)
    jplan = JPolicy(JQuant(jrf.predict), cfg).plan(j, j.view(), mask, **kw)
    tplan = MitigationPolicy(InterferenceQuantifier(trf.predict), cfg).plan(
        t, t.view(), mask, **kw)
    assert [a.proactive for a in tplan] == [a.proactive for a in jplan]
    assert any(a.proactive for a in tplan) == bool(proactive)
    assert [_plan_tuple(a) for a in tplan] == [_plan_tuple(a) for a in jplan]
    assert len(tplan) >= 2
    for a, b in zip(tplan, jplan):
        # relative: the Eq. (3) term is a float32 forest mean times 995,
        # whose ulp (~1.2e-4 at 1,500) is above an absolute 1e-4
        assert a.predicted_reduction == pytest.approx(b.predicted_reduction,
                                                      rel=1e-4)
        assert a.cost == pytest.approx(b.cost, rel=1e-9)
    for a, b in zip(tplan, jplan):
        assert a.apply(t) == b.apply(j)
    np.testing.assert_array_equal(t.slot_uids(), j.slot_uids())
    assert_state_equal(t.state, j.state)


def test_every_action_lands_in_a_replayable_log():
    from repro_torch.cluster import state as cstate
    c = _cluster(3)
    on, off, off2 = _online_pod(600.0), _offline_pod(8.0), _offline_pod(6.0)
    for p in (on, off, off2):
        assert c.place(p, 0)
    acts = [ScaleOut(node=0, uid=on.uid, workload="web_search", dst=1,
                     replica_qps=300.0),
            MigrateOnline(node=0, uid=on.uid, dst=2),
            VerticalResize(node=0, uid=off.uid, new_cores=4.0),
            EvictOffline(node=0, uid=off2.uid)]
    assert all(a.apply(c) for a in acts)
    ops = [e[0] for e in c.log[3:]]
    assert ops == ["place_on", "resize_on", "migrate_on", "resize_off",
                   "evict_off"]
    plan = cstate.extract_plan(c.log, 0.0, 1, 1)
    replayed = cstate.apply_events(
        cstate.ClusterState.create(3, device=CPU),
        {k: v[0, 0] for k, v in plan.items()})
    assert_state_equal(replayed, c.state)


def test_evict_tolerates_missing_pod_and_scale_out_rolls_back():
    c = _cluster(2)
    off = _offline_pod(8.0)
    assert c.place(off, 0)
    act = EvictOffline(node=0, uid=off.uid, cost=1.0, predicted_reduction=5.0)
    assert act.apply(c) and not act.apply(c)
    on = _online_pod(400.0)
    assert c.place(on, 0)
    so = ScaleOut(node=0, uid=on.uid, workload="web_search", dst=1,
                  replica_qps=200.0)
    c.remove(on.uid)
    before = c.active_pod_count()
    assert not so.apply(c)
    assert c.active_pod_count() == before
    assert not c.state.on_active[1].any()


def test_planned_actions_tolerate_job_finishing_before_apply():
    c = _cluster(2)
    off = _offline_pod(12.0, duration=5)
    assert c.place(off, 0)
    resize = VerticalResize(node=0, uid=off.uid, new_cores=6.0)
    evict = EvictOffline(node=0, uid=off.uid)
    c.rollout(10)
    assert not resize.apply(c) and not evict.apply(c)


def test_policy_respects_budget_and_ranks_by_net_gain():
    c = _cluster(4)
    for _ in range(3):
        assert c.place(_offline_pod(12.0), 0)
    assert c.place(_online_pod(500.0), 0)
    c.rollout(10)
    cfg = PolicyConfig(budget=10.0, max_actions_per_node=4)
    plan = MitigationPolicy(_cheap_quantifier(), cfg).plan(
        c, c.view(), np.array([True, False, False, False]))
    assert plan and sum(a.cost for a in plan) <= cfg.budget
    net = [a.predicted_reduction - cfg.cost_weight * a.cost for a in plan]
    assert all(g > 0 for g in net) and net == sorted(net, reverse=True)


def test_scale_out_relief_charges_replica_base_on_destination():
    c = _cluster(3)
    assert c.place(_online_pod(900.0), 0)
    for _ in range(3):
        assert c.place(_offline_pod(12.0), 0)
    c.rollout(10)
    policy = MitigationPolicy(_cheap_quantifier())
    view = c.view()
    cands = policy._candidates(c, view, 0, np.array([True, False, False]))
    a = next(x for x in cands if isinstance(x, ScaleOut))
    prof = ONLINE_PROFILES["web_search"]
    rho_p = policy._pressure(c, view, 0, c.pods_on_node(0))
    pred = policy.q.intf_pod(900.0, view.features).numpy() \
        * metric.OVERFLOW_EDGE
    cpu_half = prof.cpu_per_qps * 450.0
    legacy = (policy._relief(rho_p, cpu_half, float(view.cpu_sum[0]))
              + 0.3 * max(float(pred[0] - pred[a.dst]), 0.0))
    dst_cores = float(view.cpu_sum[a.dst])
    dst_add = cpu_half + prof.cpu_base
    penalty = policy._relief(
        float(view.cpu_cur[a.dst]) / dst_cores + dst_add / dst_cores,
        dst_add, dst_cores)
    assert penalty > 0
    assert a.predicted_reduction == pytest.approx(legacy - penalty)


def test_vertical_resize_respects_min_cores_floor():
    policy = MitigationPolicy(_cheap_quantifier(),
                              PolicyConfig(min_offline_cores=4.0))
    c = _cluster(2)
    small, big = _offline_pod(6.0), _offline_pod(12.0)
    assert c.place(small, 0) and c.place(big, 0)
    c.rollout(10)
    cands = policy._candidates(c, c.view(), 0, np.array([True, False]))
    resized = {a.uid for a in cands if isinstance(a, VerticalResize)}
    assert big.uid in resized and small.uid not in resized
    assert small.uid in {a.uid for a in cands if isinstance(a, EvictOffline)}


def test_policy_attribution_overrides_heuristics():
    c = _cluster(2)
    heavy, light = _offline_pod(12.0), _offline_pod(4.0)
    hi_qps, lo_qps = _online_pod(500.0), _online_pod(300.0)
    for p in (heavy, light, hi_qps, lo_qps):
        assert c.place(p, 0)
    c.rollout(10)
    policy = MitigationPolicy(_cheap_quantifier())
    view, hot = c.view(), np.array([True, False])
    attribution = np.zeros((2, 14))
    attribution[0, S_ON + c._pod_slots[light.uid][2]] = 50.0
    attribution[0, c._pod_slots[lo_qps.uid][2]] = 50.0

    def first(cands, cls):
        return next(a.uid for a in cands if isinstance(a, cls))

    base = policy._candidates(c, view, 0, hot)
    attr = policy._candidates(c, view, 0, hot, attribution=attribution)
    assert first(base, EvictOffline) == heavy.uid
    assert first(base, ScaleOut) == hi_qps.uid
    assert first(attr, EvictOffline) == light.uid
    assert first(attr, ScaleOut) == lo_qps.uid


def test_plan_corrections_demote_action_kind():
    c = _cluster(4)
    for _ in range(3):
        assert c.place(_offline_pod(12.0), 0)
    c.rollout(10)
    policy = MitigationPolicy(_cheap_quantifier(),
                              PolicyConfig(budget=10.0,
                                           max_actions_per_node=4))
    hot, view = np.array([True, False, False, False]), c.view()
    assert any(isinstance(a, EvictOffline) for a in policy.plan(c, view, hot))
    demoted = policy.plan(c, view, hot, corrections={"evict_offline": 0.0})
    assert not any(isinstance(a, EvictOffline) for a in demoted)


def test_migrate_margin_gates_destination_moves():
    """Invariant: a pod moves only across a predicted gap above
    ``migrate_margin``."""
    c = _cluster(3)
    assert c.place(_online_pod(500.0), 0)
    for _ in range(3):
        assert c.place(_offline_pod(12.0), 0)
    c.rollout(10)
    view, hot = c.view(), np.array([True, False, False])
    pred = _cheap_quantifier().intf_pod(500.0, view.features).numpy() \
        * metric.OVERFLOW_EDGE
    gap = float(pred[0] - pred[1:].min())
    assert gap > 1.0

    def migrates(margin):
        policy = MitigationPolicy(_cheap_quantifier(),
                                  PolicyConfig(migrate_margin=margin))
        return any(isinstance(a, MigrateOnline)
                   for a in policy._candidates(c, view, 0, hot))

    assert migrates(gap - 1.0) and not migrates(gap + 1.0)
    assert PolicyConfig().migrate_margin == 15.0


def test_policy_excludes_recently_acted_pods():
    c = _cluster(2)
    off = _offline_pod(12.0)
    assert c.place(off, 0)
    c.rollout(10)
    policy = MitigationPolicy(_cheap_quantifier())
    hot = np.array([True, False])
    assert policy.plan(c, c.view(), hot)
    assert policy.plan(c, c.view(), hot,
                       exclude_uids=frozenset({off.uid})) == []


# ---------------- the loop ----------------

def test_control_loop_reduces_node_delay_under_overload():
    delays = {}
    for control in (False, True):
        c = _overloaded_cluster()
        loop = ControlLoop(_cheap_quantifier()) if control else None
        for _ in range(8):
            c.rollout(10)
            if loop is not None:
                loop.step(c)
        delays[control] = float(c.last["delay"].mean())
    assert delays[True] < 0.5 * delays[False]
    assert loop.stats.actions_applied > 0 and loop.stats.hotspots_flagged > 0


def test_loop_uid_cooldown_prevents_ping_pong():
    """Invariant: a pod acted on is left alone for ``uid_cooldown`` steps."""
    c = _cluster(2)
    off = _offline_pod(12.0, duration=2000)
    assert c.place(off, 0)
    loop = ControlLoop(_cheap_quantifier(),
                       ControlLoopConfig(cooldown=0, uid_cooldown=100))
    acted_on = []
    for _ in range(6):
        c.rollout(10)
        acted_on += [getattr(a, "uid", -1) for a in loop.step(c)]
    assert acted_on.count(off.uid) <= 1
    assert ControlLoopConfig().uid_cooldown == 4


def test_control_loop_idle_on_calm_cluster():
    c = _cluster(3, seed=2)
    assert c.place(_online_pod(150.0), 0)
    loop = ControlLoop(_cheap_quantifier())
    for _ in range(6):
        c.rollout(10)
        loop.step(c)
    assert loop.stats.actions_applied == 0


def test_verification_learns_per_kind_corrections():
    c = _overloaded_cluster()
    loop = ControlLoop(_cheap_quantifier())
    for _ in range(8):
        c.rollout(10)
        loop.step(c)
    s = loop.stats
    assert s.actions_applied > 0 and s.actions_verified > 0
    assert s.predicted_reduction > 0 and np.isfinite(s.realized_reduction)
    assert s.calibration_error() >= 0
    assert loop.corrections
    for kind, corr in loop.corrections.items():
        assert loop.cfg.corr_min <= corr <= loop.cfg.corr_max
        assert kind in s.by_kind
    verified = [v for h in loop.history for v in h["verified"]]
    assert len(verified) == s.actions_verified


def test_corrections_clamp_at_corr_min():
    """Invariant: a kind that keeps under-delivering is demoted to
    ``corr_min`` (0.4) and no further."""
    c = _overloaded_cluster()
    loop = ControlLoop(_cheap_quantifier())
    assert loop.cfg.corr_min == 0.4
    c.rollout(10)
    loop.step(c)
    window_avg = c.view().node_runqlat_avg().numpy()
    for _ in range(6):
        a = EvictOffline(node=0, uid=-1, predicted_reduction=50.0)
        a.pre_runqlat = float(window_avg[0])        # realized: nothing
        loop._to_verify = [a]
        loop._verify_sig = {0: loop._node_signature(c, 0)}
        loop._verify(c, window_avg)
    assert loop.corrections["evict_offline"] == pytest.approx(0.4)


def test_verification_discards_qps_renormalised_window():
    """Invariant: contamination is judged on per-node pod signatures (uids
    AND QPS/cores), not uid sets."""
    c = _overloaded_cluster()
    loop = ControlLoop(_cheap_quantifier(), ControlLoopConfig(
        policy=PolicyConfig(destination_actions=False)))
    applied = []
    for _ in range(10):
        c.rollout(10)
        applied = loop.step(c)
        if applied:
            break
    assert applied and loop._to_verify
    node = applied[0].node
    victim = next(p for p in c.pods_on_node(node) if p["kind"] == "on")
    assert c.resize(victim["uid"], qps=victim["qps"] * 0.5)
    discarded, verified = (loop.stats.verifications_discarded,
                           loop.stats.actions_verified)
    c.rollout(10)
    loop.step(c)
    assert loop.stats.verifications_discarded > discarded
    assert loop.stats.actions_verified == verified


def test_loop_resets_attribution_on_slot_reuse():
    c = _cluster(2)
    heavy = _offline_pod(14.0, duration=2000)
    assert c.place(heavy, 0)
    loop = ControlLoop(_cheap_quantifier(),
                       ControlLoopConfig(policy=PolicyConfig(budget=0.0)))
    c.rollout(10)
    loop.step(c)
    _, node, slot = c._pod_slots[heavy.uid]
    score_heavy = float(loop.detector.slot_scores[node, S_ON + slot])
    assert score_heavy > 20
    c.remove(heavy.uid)
    tiny = _offline_pod(2.0, duration=2000)
    assert c.place(tiny, 0)
    assert c._pod_slots[tiny.uid] == ("off", node, slot)
    c.rollout(10)
    loop.step(c)
    assert float(loop.detector.slot_scores[node, S_ON + slot]) \
        < 0.3 * score_heavy


def test_loop_resets_on_new_cluster_of_same_size():
    loop = ControlLoop(_cheap_quantifier())
    c1 = _overloaded_cluster(seed=5)
    for _ in range(6):
        c1.rollout(10)
        loop.step(c1)
    assert loop.stats.actions_applied > 0 and loop._uid_last_acted
    assert loop.detector.steps > 1
    c2 = _cluster(c1.n, seed=9)
    c2.rollout(10)
    loop.step(c2)
    assert loop.detector.steps == 1
    assert not loop._uid_last_acted and not loop._pending


def test_history_is_a_bounded_ring():
    """Invariant: ``history_limit`` bounds the loop's history to the most
    recent entries."""
    runs = {}
    for limit in (512, 3):
        c = _overloaded_cluster()
        loop = ControlLoop(_cheap_quantifier(),
                           ControlLoopConfig(history_limit=limit))
        for _ in range(8):
            c.rollout(10)
            loop.step(c)
        runs[limit] = list(loop.history)
    assert len(runs[512]) > 3 and len(runs[3]) == 3
    assert runs[3] == runs[512][-3:]


def test_metrics_registry_matches_jax():
    from repro.obs import MetricsRegistry as JRegistry
    from repro_torch.obs import MetricsRegistry

    got, want = MetricsRegistry(), JRegistry()
    for reg in (got, want):
        reg.inc("steps")
        reg.inc("applied_kind.evict_offline", 2)
        reg.inc("applied_kind.migrate_online")
        reg.set("budget", 16)
        for v in range(600):
            reg.observe("plan_ms", v % 97)
    assert got.snapshot() == want.snapshot()
    assert got.counters("applied_kind.") == {
        "applied_kind.evict_offline": 2.0, "applied_kind.migrate_online": 1.0}
    assert got.value("missing") == 0.0
    assert got.histogram("plan_ms").count == 600
    assert len(got.histogram("plan_ms").ring) == 512


class _StuckCluster:
    CHUNK = 10
    n = 2
    t = 0.0
    device = CPU

    def rollout(self, k):
        pass


def test_run_raises_on_zero_rollout_progress():
    with pytest.raises(RuntimeError, match="no progress"):
        ControlLoop(_cheap_quantifier()).run(_StuckCluster(), num_ticks=30)


def test_loop_run_interleaves_rollout_and_control():
    c = _overloaded_cluster()
    stats = ControlLoop(_cheap_quantifier()).run(c, num_ticks=60, k=20)
    assert stats.steps == 3 and stats.actions_applied > 0


def test_scheduler_profiles_match_jax():
    """Invariant: RR and HUP keep source relief only
    (``destination_actions=False``); every profile equals JAX's."""
    for name, pro in [(n, p) for n in ("ICO", "ICO-F", "RR", "HUP", "LQP",
                                       "unknown") for p in (False, True)]:
        got, want = scheduler_loop_config(name, pro), jprofile(name, pro)
        assert got.proactive == pro
        for f in dataclasses.fields(got):
            g, w = getattr(got, f.name), getattr(want, f.name)
            if dataclasses.is_dataclass(g):
                assert dataclasses.asdict(g) == dataclasses.asdict(w), f.name
            else:
                assert g == w, f.name
    assert scheduler_loop_config("ICO").policy.destination_actions
    for name in ("RR", "HUP"):
        assert not SCHEDULER_PROFILES[name].policy.destination_actions
    assert scheduler_loop_config("unknown") == ControlLoopConfig()


def _run_small(**kw):
    pods, gaps = texp.bursty_trace(num_online=5, num_bursts=1,
                                   jobs_per_burst=2, seed=1)
    return pods, texp.run_experiment(
        kw.pop("sched", TICO(_cheap_quantifier())), pods, gaps, num_nodes=6,
        seed=3, settle_ticks=10, control_window=20, device=CPU, **kw)


@pytest.mark.parametrize("call", [
    "proactive_loop", "proactive_profile", "forecast_service", "recorder",
    "run_experiment_forecast", "run_experiment_recorder",
    "make_schedulers_forecast"])
def test_formerly_refused_calls_now_run(call):
    """The calls the reactive slice refused run now (each is held to JAX by
    the parity tests of ``test_torch_forecast`` / ``test_torch_obs`` and
    the proactive run below)."""
    q = _cheap_quantifier()
    if call in ("proactive_loop", "proactive_profile"):
        cfg = (ControlLoopConfig(proactive=True) if call == "proactive_loop"
               else scheduler_loop_config("ICO", proactive=True))
        loop = ControlLoop(q, cfg)
        c = _overloaded_cluster()
        for _ in range(3):
            c.rollout(10)
            loop.step(c)
        assert loop.forecast_service.device == c.device
        assert int(loop.forecaster.count.sum()) > 0
    elif call == "forecast_service":
        svc = ForecastService(device=CPU)
        loop = ControlLoop(q, ControlLoopConfig(proactive=True),
                           forecast_service=svc)
        _, r = _run_small(control_loop=loop, forecast=svc)
        assert loop.forecast_service is svc and svc.forecaster is not None
        assert r.proactive_mitigations <= r.mitigations
    elif call == "recorder":
        rec = TraceRecorder()
        loop = ControlLoop(q, recorder=rec)
        loop.run(_overloaded_cluster(), num_ticks=60, k=20)
        assert loop.recorder is rec and rec.query("hotspot")
    elif call == "run_experiment_forecast":
        svc = ForecastService(device=CPU)
        pods, r = _run_small(sched=ICOFScheduler(q), forecast=lambda: svc)
        assert r.placed + r.rejected == len(pods) and svc._dt is not None
    elif call == "run_experiment_recorder":
        rec = TraceRecorder()
        pods, r = _run_small(recorder=rec, control_loop=ControlLoop(q))
        assert r.placed == len(rec.query("admission", placed=True))
        assert rec.query("phase_timings")
    else:
        scheds = texp.make_schedulers(_CheapPredictor(), forecast=True)
        assert list(scheds) == ["ICO", "RR", "HUP", "LQP", "ICO-F"]
        assert isinstance(scheds["ICO-F"], ICOFScheduler)


# ---------------- the controlled experiment ----------------

_RUNS: dict = {}


def _controlled(name, forests):
    """JAX's and the port's controlled runs of one scheduler on the
    12-node bursty trace, JAX's draws injected (cached per module)."""
    if name in _RUNS:
        return _RUNS[name]
    jrf, trf = forests
    pods, gaps = jexp.bursty_trace(num_online=14, seed=0)
    if name == "ICO":
        jsched, tsched = JICO(JQuant(jrf.predict)), TICO(
            InterferenceQuantifier(trf.predict))
    else:
        jsched, tsched = JRR(), TRR()
    jloop = JLoop(JQuant(jrf.predict), jprofile(name))
    want = jexp.run_experiment(jsched, pods, gaps, num_nodes=12, seed=7,
                               control_loop=jloop, control_window=40,
                               fast=False)
    plan: dict = {}
    tloop = ControlLoop(InterferenceQuantifier(trf.predict),
                        scheduler_loop_config(name))
    got = texp.run_experiment(tsched, pods, gaps, num_nodes=12, seed=7,
                              control_loop=tloop, control_window=40,
                              device=CPU, noise=jax_noise_stream(7, 12),
                              plan_out=plan)
    _RUNS[name] = (want, got, jloop, tloop, plan)
    return _RUNS[name]


@pytest.mark.parametrize("name", ["ICO", "RR"])
def test_controlled_run_matches_jax(name, forests):
    want, got, jloop, tloop, _ = _controlled(name, forests)
    for f in ("placed", "rejected", "queued_retries", "mitigations"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.mitigations > 5
    for f in ("avg_rt", "p90_rt", "p99_rt"):
        assert getattr(got, f) == pytest.approx(getattr(want, f), rel=1e-4), f
    for f in ("predicted_reduction", "realized_reduction"):
        assert getattr(got, f) == pytest.approx(getattr(want, f), rel=1e-4), f
    assert tloop.stats.by_kind == jloop.stats.by_kind
    assert tloop.stats.hotspots_flagged == jloop.stats.hotspots_flagged
    if name == "RR":       # source relief only
        assert set(tloop.stats.by_kind) <= {"evict_offline",
                                            "vertical_resize"}
    assert set(tloop.timers.totals) >= {"rollout", "snapshot", "verify",
                                        "detect", "plan"}


def test_mitigated_plan_replays_the_run(forests):
    _, got, _, _, plan = _controlled("ICO", forests)
    assert any(e[0].startswith(("migrate", "resize", "evict"))
               for e in plan["log"])
    rep = texp.replay_plan_batched(
        plan, sim_seeds=[7, 8], device=CPU,
        noise=[jax_noise_stream(s, 12) for s in (7, 8)])
    by_seed = {e["sim_seed"]: e for e in rep["seeds"]}
    for f in ("avg_rt", "p90_rt", "p99_rt"):
        assert by_seed[7][f] == pytest.approx(getattr(got, f), rel=1e-3), f
    assert by_seed[8]["avg_rt"] != pytest.approx(got.avg_rt, rel=1e-3)


class _EvictOnlineLoop:
    """A loop stand-in that removes every online pod at each step."""

    def __init__(self):
        self.timers = PhaseTimers()
        self.stats = ControlStats()

    def step(self, cluster, view=None):
        gone = [uid for uid, (kind, _, _) in cluster._pod_slots.items()
                if kind == "on"]
        for uid in gone:
            cluster.remove(uid)
        return gone


class _NodeZero:
    name = "zero"

    def select_node(self, pod, view):
        return 0


def test_rt_is_sampled_before_the_loop_steps():
    """Invariant: the window's RT is taken before mitigation moves pods;
    sampled after, the evicted pod's samples would vanish (NaN here)."""
    pods, gaps = [_online_pod(300.0)], [20]
    r = texp.run_experiment(_NodeZero(), pods, gaps, num_nodes=1,
                            settle_ticks=10, control_loop=_EvictOnlineLoop(),
                            device=CPU)
    assert np.isfinite(r.avg_rt) and r.avg_rt > 0


def test_run_experiment_reports_per_run_mitigation_delta():
    pods, gaps = texp.bursty_trace(num_online=6, num_bursts=2,
                                   jobs_per_burst=2, seed=1)
    loop = ControlLoop(_cheap_quantifier())
    kw = dict(num_nodes=6, seed=3, settle_ticks=10, control_loop=loop,
              device=CPU)
    r1 = texp.run_experiment(TICO(_cheap_quantifier()), pods, gaps, **kw)
    r2 = texp.run_experiment(TICO(_cheap_quantifier()), pods, gaps, **kw)
    assert r1.mitigations > 0
    assert r1.mitigations + r2.mitigations == loop.stats.actions_applied
    assert (r1.predicted_reduction + r2.predicted_reduction
            == pytest.approx(loop.stats.predicted_reduction))


class _CheapPredictor:
    @staticmethod
    def predict(X):
        return X[:, 21]


def test_compare_schedulers_threads_a_loop_per_scheduler():
    pods, gaps = texp.bursty_trace(num_online=5, num_bursts=1,
                                   jobs_per_burst=2, seed=1)
    res = texp.compare_schedulers(num_nodes=6, seed=3,
                                  predictor=_CheapPredictor(), control=True,
                                  trace=(pods, gaps), device=CPU)
    assert list(res) == ["ICO", "RR", "HUP", "LQP"]
    for r in res.values():
        assert np.isfinite(r.p99_rt) and r.mitigations >= 0
        assert r.placed + r.rejected == len(pods)
        assert np.isfinite([r.predicted_reduction, r.realized_reduction]).all()


# ---------------- the proactive channel ----------------

def _proactive_runs():
    """JAX's and the port's proactive ICO runs (the loop owns its service)
    on a half-day 12-node trace, JAX's draws injected.  The leverage gate
    is widened (``max_leverage`` 1.0) in both, so that it opens within the
    trace."""
    pods, gaps = jexp.bursty_trace(num_online=14, seed=3, burst_gap=(40, 70),
                                   days=0.5)
    jq = JQuant(lambda X: np.full(np.asarray(X).shape[0], 0.1))
    jcfg = dataclasses.replace(jprofile("ICO", proactive=True),
                               forecast=JForecastConfig(max_leverage=1.0))
    jloop = JLoop(jq, jcfg)
    want = jexp.run_experiment(JICO(jq), pods, gaps, num_nodes=12, seed=3,
                               control_loop=jloop, control_window=40)
    tq = InterferenceQuantifier(lambda X: torch.full((X.shape[0],), 0.1))
    tcfg = dataclasses.replace(scheduler_loop_config("ICO", proactive=True),
                               forecast=ForecastConfig(max_leverage=1.0))
    tloop = ControlLoop(tq, tcfg)
    got = texp.run_experiment(TICO(tq), pods, gaps, num_nodes=12, seed=3,
                              control_loop=tloop, control_window=40,
                              device=CPU, noise=jax_noise_stream(3, 12))
    return want, got, jloop, tloop


def test_proactive_run_matches_jax():
    want, got, jloop, tloop = _proactive_runs()
    for f in ("placed", "rejected", "queued_retries", "mitigations",
              "proactive_mitigations"):
        assert getattr(got, f) == getattr(want, f), f
    for f in ("avg_rt", "p90_rt", "p99_rt", "predicted_reduction",
              "realized_reduction"):
        assert getattr(got, f) == pytest.approx(getattr(want, f), rel=1e-4), f
    js, ts = jloop.stats, tloop.stats
    for f in ("steps", "hotspots_flagged", "proactive_flagged",
              "actions_applied", "proactive_applied", "actions_verified",
              "verifications_discarded", "by_kind"):
        assert getattr(ts, f) == getattr(js, f), f
    assert ts.proactive_applied > 0
    assert ([h["proactive_nodes"] for h in tloop.history]
            == [h["proactive_nodes"] for h in jloop.history])
    assert tloop.forecaster.calibration_error() == pytest.approx(
        jloop.forecaster.calibration_error(), rel=1e-4)
    assert "forecast" in tloop.timers.totals


def test_compare_schedulers_forecast_adds_icof():
    """forecast=True adds ICO-F with a per-run service; on a short trace the
    gate never opens, so ICO-F's run is ICO's."""
    pods, gaps = texp.bursty_trace(num_online=5, num_bursts=1,
                                   jobs_per_burst=2, seed=1)
    res = texp.compare_schedulers(num_nodes=6, seed=3,
                                  predictor=_CheapPredictor(), forecast=True,
                                  trace=(pods, gaps), control_window=20,
                                  device=CPU)
    assert list(res) == ["ICO", "RR", "HUP", "LQP", "ICO-F"]
    assert res["ICO-F"].p99_rt == res["ICO"].p99_rt
    assert res["ICO-F"].placed == res["ICO"].placed
    assert scheduler_loop_config("ICO-F").policy.destination_actions


def test_compare_schedulers_proactive_shares_a_service():
    pods, gaps = texp.bursty_trace(num_online=5, num_bursts=1,
                                   jobs_per_burst=2, seed=1)
    res = texp.compare_schedulers(num_nodes=6, seed=3,
                                  predictor=_CheapPredictor(), control=True,
                                  proactive=True, forecast=True,
                                  trace=(pods, gaps), control_window=20,
                                  device=CPU)
    assert set(res) == {"ICO", "ICO-F", "RR", "HUP", "LQP"}
    for r in res.values():
        assert r.placed + r.rejected == len(pods) and np.isfinite(r.p99_rt)
        assert 0 <= r.proactive_mitigations <= r.mitigations


def test_loop_proactive_smoke_and_stats():
    c = _overloaded_cluster()
    loop = ControlLoop(_cheap_quantifier(), ControlLoopConfig(proactive=True))
    for _ in range(8):
        c.rollout(10)
        loop.step(c)
    s = loop.stats
    assert s.actions_applied > 0
    assert 0 <= s.proactive_applied <= s.actions_applied
    assert loop.forecaster is not None and loop.forecaster.last_pred is not None
    cal = loop.forecaster.calibration_error()
    assert np.isnan(cal) or cal >= 0
    for h in loop.history:
        assert "proactive_nodes" in h


def test_run_experiment_threads_proactive_counters():
    loop = ControlLoop(_cheap_quantifier(), ControlLoopConfig(proactive=True))
    _, r = _run_small(control_loop=loop)
    assert r.proactive_mitigations == loop.stats.proactive_applied
    assert r.proactive_mitigations <= r.mitigations and np.isfinite(r.p99_rt)


def test_core_reexports_control_api():
    import repro_torch.core as core

    assert core.ControlLoop is ControlLoop
    assert core.ControlLoopConfig is ControlLoopConfig
    with pytest.raises(AttributeError):
        core.definitely_not_a_symbol
