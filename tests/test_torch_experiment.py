"""The port's experiment driver against ``repro.cluster.experiment``: the
whole ICO pipeline on one trace, first with JAX's draws injected, then with
the port's own generator compared by distribution."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.cluster import experiment as jexp
from repro.cluster.simulator import Cluster as JCluster
from repro.core.interference import InterferenceQuantifier as JQuant
from repro.core.predictors.forest import RandomForestRegressor as JForest
from repro.core.scheduler import ICOScheduler as JICO
from repro_torch.cluster import experiment as texp
from repro_torch.cluster.dataset import generate_latency_dataset
from repro_torch.cluster.simulator import Cluster as TCluster
from repro_torch.convert import forest_from_numpy
from repro_torch.core.interference import InterferenceQuantifier as TQuant
from repro_torch.core.scheduler import ICOScheduler as TICO
from test_torch_noise import jax_noise_stream


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the module's tests: under the suite's
    several worker processes, torch's default of one thread a core in each
    makes their small CPU kernels spin against each other, and alone on an
    8-core CPU the module took 22 s at one thread against 22 s at eight."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def forests():
    from repro.cluster.dataset import generate_latency_dataset as jdata

    X, y = jdata(num_placements=40, num_nodes=6, seed=2)
    jrf = JForest(n_estimators=8, max_depth=6, seed=2).fit(X, y)
    return jrf, forest_from_numpy(jrf, device=CPU)


def test_ico_run_with_jax_noise_matches_jax(forests):
    """12 nodes, 20 pods, every tick fed JAX's draws: the same placements
    and rejections, avg/p90/p99 RT within rtol 1e-4."""
    jrf, trf = forests
    pods, gaps = jexp._arrival_trace(20, seed=7)
    want = jexp.run_experiment(JICO(JQuant(jrf.predict)), pods, gaps,
                               num_nodes=12, seed=7, fast=False)
    got = texp.run_experiment(TICO(TQuant(trf.predict)), pods, gaps,
                              num_nodes=12, seed=7, device="cpu",
                              noise=jax_noise_stream(7, 12))
    assert (got.placed, got.rejected, got.queued_retries) == \
        (want.placed, want.rejected, want.queued_retries)
    assert got.placed > 10
    for f in ("avg_rt", "p90_rt", "p99_rt", "cpu_util_std", "mem_util_std"):
        assert getattr(got, f) == pytest.approx(getattr(want, f), rel=1e-4), f


def _fixed_placement(cls, **kw):
    c = cls(num_nodes=6, seed=3, **kw)
    pods, _ = jexp._arrival_trace(14, seed=3)
    for i, pod in enumerate(pods):
        c.place(dataclasses.replace(pod), i % 6)
    return c


def test_own_generator_matches_jax_in_distribution():
    """One fixed placement, ~200 ticks, the port's own generator against
    JAX's keys: the per-tick mean RT differs by noise only (paired test,
    within 3 standard errors)."""
    j, t = _fixed_placement(JCluster), _fixed_placement(TCluster, device="cpu")
    assert t.log == j.log
    jrt, trt = [], []
    for _ in range(10):
        j.rollout(20)
        t.rollout(20)
        mask = np.asarray(j.state.on_active)
        jrt.append(np.where(mask, j.last["rt"], np.nan))
        trt.append(np.where(mask, t.last["rt"].numpy(), np.nan))
    jrt, trt = np.concatenate(jrt), np.concatenate(trt)   # (200, N, S_ON)
    assert jrt.shape == (200, 6, 8)
    d = np.nanmean(trt, axis=(1, 2)) - np.nanmean(jrt, axis=(1, 2))
    se = d.std(ddof=1) / np.sqrt(d.size)
    assert abs(d.mean()) < 3 * se, (d.mean(), se)
    assert np.nanstd(trt) == pytest.approx(np.nanstd(jrt), rel=0.15)


def test_compare_schedulers_table(forests):
    _, trf = forests
    out = texp.compare_schedulers(num_pods=8, num_nodes=6, seed=1,
                                  predictor=trf, device="cpu")
    assert list(out) == ["ICO", "RR", "HUP", "LQP"]
    for name, r in out.items():
        assert r.scheduler == name
        assert r.placed + r.rejected == 8
        assert np.isfinite([r.avg_rt, r.p90_rt, r.p99_rt]).all()
        assert r.avg_rt <= r.p99_rt


def test_dataset_and_default_predictor_on_cpu():
    X, y = generate_latency_dataset(num_placements=12, num_nodes=4, seed=0,
                                    device="cpu")
    assert X.shape[1] == 46 and X.shape[0] == y.shape[0] > 0
    assert np.isfinite(X).all() and (y >= 0).all()
    rf = texp.train_default_predictor(seed=0, num_placements=12, device="cpu")
    pred = rf.predict(X[:, :])
    assert pred.shape == (X.shape[0],) and torch.isfinite(pred).all()


def test_run_experiment_refuses_a_recorder(forests):
    """Named for the refusal it held while the trace recorder was not
    ported; now ``run_experiment(recorder=)`` takes one, only observes (the
    run equals an untraced one), and records JAX's admissions."""
    from repro.obs import TraceRecorder as JRecorder
    from repro_torch.obs import TraceRecorder

    jrf, trf = forests
    pods, gaps = jexp._arrival_trace(6, seed=0)
    kw = dict(num_nodes=6, seed=3, device="cpu")
    rec = TraceRecorder()
    traced = texp.run_experiment(TICO(TQuant(trf.predict)), pods, gaps,
                                 recorder=rec, noise=jax_noise_stream(3, 6),
                                 **kw)
    plain = texp.run_experiment(TICO(TQuant(trf.predict)), pods, gaps,
                                noise=jax_noise_stream(3, 6), **kw)
    assert traced == plain
    jrec = JRecorder()
    jexp.run_experiment(JICO(JQuant(jrf.predict)), pods, gaps, num_nodes=6,
                        seed=3, recorder=jrec)
    got, want = rec.query("admission"), jrec.query("admission")
    assert [(e.chosen, e.uid, e.placed) for e in got] == \
        [(e.chosen, e.uid, e.placed) for e in want]


def test_bursty_trace_matches_jax():
    for kw in ({}, {"days": 0.2, "seed": 3}):
        jp, jg = jexp.bursty_trace(**kw)
        tp, tg = texp.bursty_trace(**kw)
        assert tg == jg
        assert [dataclasses.astuple(p) for p in tp] == \
            [dataclasses.astuple(p) for p in jp]


@pytest.mark.parametrize("n_rows", [6, 37])
def test_forest_prediction_is_row_independent_as_jax(forests, n_rows):
    """Identical feature rows (fresh, empty nodes) get identical
    predictions, bit for bit JAX's for this 8-tree forest, so ICO breaks
    argmax ties as JAX does.  Reduced over axis 0 of the (trees, rows)
    layout, the CPU's trailing rows took another vector path and came out
    an ulp apart."""
    from repro_torch.core.predictors import trees as T

    jrf, trf = forests
    rng = np.random.default_rng(n_rows)
    X = rng.uniform(0, 1, (n_rows, 45)).astype(np.float32) * 300
    X[n_rows // 2:] = X[0]
    got = trf.predict(torch.as_tensor(X)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jrf.predict(X)))
    assert len(set(got[n_rows // 2:].tolist())) == 1 and got[0] == got[-1]
    leaves = T.forest_predict(trf.forest, torch.as_tensor(X), trf.max_depth)
    assert T.tree_rows(leaves).is_contiguous()
    assert torch.equal(T.tree_rows(leaves), leaves.t())
