"""The port's Eq. 1/3 quantifier, Random-Forest inference and schedulers
against ``repro.core`` on the same converted trees and ``ClusterView``s."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cluster import fleet as jfleet
from repro.cluster.dataset import _random_pod, generate_latency_dataset
from repro.cluster.simulator import Cluster as JCluster
from repro.core import baselines as jbase
from repro.core import interference as jintf
from repro.core import scheduler as jsched
from repro.core.predictors import trees as jtrees
from repro.core.predictors.features import runqlat_summary as jsummary
from repro.core.predictors.forest import RandomForestRegressor as JForest
from repro_torch.cluster import fleet as tfleet
from repro_torch.convert import forest_from_numpy, view_from_numpy
from repro_torch.core import baselines as tbase
from repro_torch.core import interference as tintf
from repro_torch.core import scheduler as tsched
from repro_torch.core.predictors import trees as ttrees
from repro_torch.core.predictors.features import runqlat_summary as tsummary

CPU = torch.device("cpu")
RTOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def forests():
    """A JAX forest fitted on simulator telemetry and its port twin."""
    X, y = generate_latency_dataset(num_placements=40, num_nodes=6, seed=1)
    jrf = JForest(n_estimators=8, max_depth=6, seed=1).fit(X, y)
    return jrf, forest_from_numpy(jrf, device=CPU), X


def test_forest_predict_matches_jax(forests):
    jrf, trf, X = forests
    rng = np.random.default_rng(0)
    # training rows, rows nudged off them, and rows sitting on thresholds
    thr = np.asarray(jrf.forest["threshold"])
    feat = np.asarray(jrf.forest["feature"])
    on_thr = X[:8].copy()
    for r in range(8):
        t, n = rng.integers(thr.shape[0]), rng.integers(thr.shape[1])
        if feat[t, n] >= 0:
            on_thr[r, feat[t, n]] = thr[t, n]
    rows = np.concatenate([X, X * (1 + 0.01 * rng.standard_normal(X.shape)),
                           on_thr])
    want = np.asarray(jtrees.forest_predict(jrf.forest, jnp.asarray(rows),
                                            jrf.max_depth))
    got = ttrees.forest_predict(trf.forest, torch.as_tensor(rows),
                                trf.max_depth).numpy()
    np.testing.assert_array_equal(got, want)      # (T, N) leaf values
    np.testing.assert_allclose(trf.predict(rows).numpy(), jrf.predict(rows),
                               **RTOL)


def test_node_interference_matches_jax():
    rng = np.random.default_rng(1)
    on = rng.poisson(2.0, (5, 8, 200)).astype(np.float32)
    off = rng.poisson(1.0, (5, 6, 200)).astype(np.float32)
    on[0] = 0.0                                   # an empty node
    want = jintf.node_interference(jnp.asarray(on), jnp.asarray(off), 2.5, 1.3)
    got = tintf.node_interference(torch.from_numpy(on), torch.from_numpy(off),
                                  2.5, 1.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **RTOL)
    assert float(got[0]) == pytest.approx(
        1.3 * float(tintf.node_interference(
            torch.zeros(1, 8, 200), torch.from_numpy(off[:1]))[0]) / 1.2)


def test_runqlat_summary_matches_jax():
    rng = np.random.default_rng(2)
    hists = rng.poisson(1.5, (4, 200)).astype(np.float32) * 3
    hists[1] = 0.0
    got = tsummary(torch.from_numpy(hists)).numpy()
    want = np.stack([jsummary(h) for h in hists])
    assert got.shape == want.shape == (4, 25)
    # band masses round as JAX's float64 values do when read as float32
    np.testing.assert_array_equal(got, want.astype(np.float32))


def _pods(n, seed):
    rng = np.random.default_rng(seed)
    return [_random_pod(rng) for _ in range(n)]


def _views(cluster_kw, seed, num_pods, ticks):
    """A JAX ClusterView after placing ``num_pods`` pods round-robin."""
    c = JCluster(seed=seed, **cluster_kw)
    c.rollout(30)
    views = [c.view()]
    for i, pod in enumerate(_pods(num_pods, seed)):
        c.place(pod, (7 * i) % c.n)
    c.rollout(ticks)
    views.append(c.view())
    return views


def _pair(jrf, trf):
    jq = jintf.InterferenceQuantifier(jrf.predict)
    tq = tintf.InterferenceQuantifier(trf.predict)
    return {
        "ICO": (jsched.ICOScheduler(jq), tsched.ICOScheduler(tq)),
        "RR": (jbase.RoundRobinScheduler(), tbase.RoundRobinScheduler()),
        "HUP": (jbase.HUPScheduler(jq), tbase.HUPScheduler(tq)),
        "LQP": (jbase.LQPScheduler(), tbase.LQPScheduler()),
    }


def _check_same_choices(forests, jviews, tfleet_=None):
    jrf, trf, _ = forests
    scheds = _pair(jrf, trf)
    chosen = {name: [] for name in scheds}
    big = dataclasses.replace(_pods(1, 0)[0], cpu_demand=500.0)  # fits nowhere
    for jview in jviews:
        tview = view_from_numpy(jview, device=CPU, fleet=tfleet_)
        for pod in _pods(12, 3) + [big]:
            for name, (js, ts) in scheds.items():
                jbest, tbest = js.select_node(pod, jview), ts.select_node(pod, tview)
                assert tbest == jbest, (name, pod)
                chosen[name].append(tbest)
            ico_j, ico_t = scheds["ICO"]
            np.testing.assert_allclose(ico_t.scores(pod, tview).numpy(),
                                       ico_j.scores(pod, jview), **RTOL)
    return chosen


def test_schedulers_pick_same_node_at_12_nodes(forests):
    chosen = _check_same_choices(forests, _views({"num_nodes": 12}, 4, 20, 40))
    assert len(set(chosen["ICO"]) - {-1}) > 1      # real choices were made
    assert chosen["ICO"][-1] == -1                 # the oversized pod


def test_ico_topk_path_on_100_node_fleet(forests):
    """Past candidate_k nodes ICO scores a prefiltered set; on the empty
    fleet every node of a class ties and the lowest indices win."""
    mix = {"std32": 6, "hi96": 1, "lo16": 3}
    jviews = _views({"fleet": jfleet.make_fleet(100, mix, seed=0)}, 2, 60, 30)
    assert jviews[0].num_nodes > jsched.SchedulerConfig().candidate_k
    assert np.all(jviews[0].cpu_cur == np.float32(0.5))  # the all-empty tie
    chosen = _check_same_choices(forests, jviews,
                                 tfleet.make_fleet(100, mix, seed=0))
    assert len(set(chosen["ICO"]) - {-1}) > 1
    # top-k scores outside the candidate set are -inf on both sides
    jrf, trf, _ = forests
    pod = _pods(1, 9)[0]
    tview = view_from_numpy(jviews[1], device=CPU)
    score = tsched.ICOScheduler(
        tintf.InterferenceQuantifier(trf.predict)).scores(pod, tview)
    assert int(torch.isfinite(score).sum()) <= 64


def test_view_take_reindexes_host_fields():
    jview = _views({"fleet": jfleet.make_fleet(20, seed=1)}, 1, 4, 10)[1]
    tview = view_from_numpy(jview, device=CPU)
    idx = np.asarray([3, 0, 17])
    jt, tt = jview.take(idx), tview.take(torch.as_tensor(idx))
    assert tt.node_class == jt.node_class
    assert tt.delay_base.dtype == np.float64
    np.testing.assert_array_equal(tt.delay_base, jt.delay_base)
    np.testing.assert_array_equal(tt.slot_uids, jt.slot_uids)
    np.testing.assert_array_equal(tt.features.numpy(),
                                  jt.features.astype(np.float32))
