"""``benchmarks/bench_torch_schedulers.py`` against JAX's
``bench_schedulers`` with JAX's draws injected and one small JAX forest
carried across (``convert.forest_from_numpy``): the headline table (12
nodes, a 12-pod trace), the batched axis over two sim seeds and the
forecast axis on a short bursty trace with the leverage gate widened
(``ForecastConfig(max_leverage=1.0)`` in both packages).  JAX's side runs
its bench's own functions where its module constants, its predictor and
its ``ForecastService`` can be set from here, and otherwise the same
library calls."""
import dataclasses
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import repro.control
from repro.cluster import experiment as jexp
from repro.control import ForecastConfig as JForecastConfig
from repro.control import ForecastService as JService
from repro.core.predictors.forest import RandomForestRegressor as JForest
from repro_torch.control import ForecastConfig
from repro_torch.convert import forest_from_numpy
from repro_torch.obs import explain
from test_torch_noise import jax_noise_stream


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the module's tests: under the suite's
    several worker processes, torch's default of one thread a core in each
    makes their small CPU kernels spin against each other, and alone on an
    8-core CPU the module took 53 s at one thread against 74 s at eight."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
N_PODS, SIM_SEEDS = 12, (7, 8)
STATS = ("avg_rt", "p90_rt", "p99_rt", "cpu_util_std", "mem_util_std")
# a quarter-day trace whose bursts come often enough for the widened gate
SHORT_TRACE = dict(num_online=14, burst_gap=(40, 70), days=0.25)
SHORT_SEEDS = [(3, 3)]
OPEN_GATE = dict(max_leverage=1.0)


def _load(rel):
    path = ROOT / rel
    spec = importlib.util.spec_from_file_location(f"_bench_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def benches():
    return _load("benchmarks/bench_schedulers.py"), _load(
        "benchmarks/bench_torch_schedulers.py")


@pytest.fixture(scope="module")
def forests():
    from repro.cluster.dataset import generate_latency_dataset as jdata

    X, y = jdata(num_placements=40, num_nodes=6, seed=2)
    jrf = JForest(n_estimators=8, max_depth=6, seed=2).fit(X, y)
    return jrf, forest_from_numpy(jrf, device=CPU)


@pytest.fixture(scope="module")
def headline(benches, forests):
    _, tb = benches
    jrf, trf = forests
    want = jexp.compare_schedulers(num_pods=N_PODS, num_nodes=12, seed=7,
                                   predictor=jrf)
    out, doc, plans = [], {"schedulers": {}}, {}
    got = tb.headline(out, doc, N_PODS, device=CPU, predictor=trf,
                      noise=jax_noise_stream, plans=plans)
    return want, got, out, doc, plans


@pytest.fixture(scope="module")
def batched(benches, forests):
    """JAX's ``_batched_axis`` with its predictor set to the small forest,
    and the port's axis rerunning each scheduler, both on two seeds."""
    jb, tb = benches
    jrf, trf = forests
    jout, jdoc = [], {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jb, "train_default_predictor", lambda **kw: jrf)
        jb._batched_axis(jout, jdoc, n_pods=N_PODS, fast=True,
                         sim_seeds=SIM_SEEDS)
    tout, tdoc = [], {}
    per = tb.batched_axis(tout, tdoc, trf, N_PODS, device=CPU,
                          sim_seeds=SIM_SEEDS, noise=jax_noise_stream)
    return (jout, jdoc), (tout, tdoc, per)


def test_headline_equals_jax(headline):
    want, got, out, doc, plans = headline
    assert list(got) == list(want) == ["ICO", "RR", "HUP", "LQP"]
    for name, w in want.items():
        g = got[name]
        assert (g.placed, g.rejected) == (w.placed, w.rejected), name
        assert g.placed + g.rejected == N_PODS
        for f in STATS:
            assert getattr(g, f) == pytest.approx(getattr(w, f),
                                                  rel=1e-4), (name, f)
        assert doc["schedulers"][name]["p99_rt"] == g.p99_rt
        assert plans[name]["seed"] == 7 and plans[name]["log"]
    assert [r[0] for r in out] == [f"torch.schedulers.{n}" for n in want]
    assert "vs_hup_avg=+0.0%" in out[2][2]


def test_batched_axis_equals_jax(batched):
    (jout, jdoc), (tout, tdoc, _) = batched
    assert tdoc["batched"]["sim_seeds"] == list(SIM_SEEDS)
    jsch, tsch = jdoc["batched"]["schedulers"], tdoc["batched"]["schedulers"]
    assert list(tsch) == list(jsch)
    for name, w in jsch.items():
        g = tsch[name]
        np.testing.assert_allclose(g["p99_per_seed"], w["p99_per_seed"],
                                   rtol=1e-4, err_msg=name)
        for k in ("p99_mean", "avg_mean", "avg_std"):
            assert g[k] == pytest.approx(w[k], rel=1e-4), (name, k)
        assert g["p99_std"] == pytest.approx(w["p99_std"], rel=1e-3,
                                             abs=1e-3), name
        assert (g["wins_vs_hup"], g["losses_vs_hup"]) == (
            w["wins_vs_hup"], w["losses_vs_hup"]), name
    assert [r[0] for r in tout] == ["torch." + r[0] for r in jout]
    for j, t in zip(jout, tout):
        assert t[2].split(";")[-1] == j[2].split(";")[-1]   # wins_vs_hup


def test_replay_of_headline_plans_is_the_headline(benches, forests,
                                                  headline, batched):
    """With one forest the axis replays the headline's plans: the same
    per-seed numbers as rerunning, and the seed-7 entry is the headline
    run."""
    _, tb = benches
    _, trf = forests
    want, got, _, _, plans = headline
    _, (_, tdoc, _) = batched
    out, doc = [], {}
    per = tb.batched_axis(out, doc, trf, N_PODS, device=CPU,
                          sim_seeds=SIM_SEEDS, noise=jax_noise_stream,
                          plans=plans)
    for name, d in per.items():
        assert d["p99"] == tdoc["batched"]["schedulers"][name][
            "p99_per_seed"]
        seed7 = d["replay"]["seeds"][SIM_SEEDS.index(7)]
        for f in ("avg_rt", "p90_rt", "p99_rt"):
            assert seed7[f] == pytest.approx(getattr(got[name], f),
                                             rel=1e-4), (name, f)


@pytest.fixture(scope="module")
def forecast(benches, forests, tmp_path_factory):
    """JAX's ``_forecast_axis`` on the short trace with the gate widened
    (its constants, predictor and service set here; its ``run_experiment``
    wrapped to keep the results), and the port's, traced."""
    jb, tb = benches
    jrf, trf = forests
    seen = []

    def keep(*a, **kw):
        r = jexp.run_experiment(*a, **kw)
        seen.append((r, kw.get("forecast") is not None))
        return r

    jout = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jb, "FORECAST_TRACE", SHORT_TRACE)
        mp.setattr(jb, "FORECAST_SEEDS", SHORT_SEEDS)
        mp.setattr(jb, "train_default_predictor", lambda **kw: jrf)
        mp.setattr(jb, "run_experiment", keep)
        mp.setattr(repro.control, "ForecastService",
                   lambda: JService(JForecastConfig(**OPEN_GATE)))
        jb._forecast_axis(jout, fast=True)
    path = str(tmp_path_factory.mktemp("fc") / "icof.jsonl")
    tout, tdoc = [], {}
    rows = tb.forecast_axis(tout, tdoc, trf, device=CPU, trace_path=path,
                            seeds=SHORT_SEEDS, trace=SHORT_TRACE,
                            config=ForecastConfig(**OPEN_GATE),
                            noise=jax_noise_stream)
    return (jout, seen), (tout, tdoc, rows, path)


def test_forecast_axis_equals_jax(forecast):
    (jout, seen), (tout, tdoc, rows, _) = forecast
    assert [s[1] for s in seen] == [False, True, False]   # ICO, ICO-F, fb
    j_ico, j_icof, j_fb = (s[0] for s in seen)
    row = rows[0]
    for got, want in ((row["ico"], j_ico), (row["icof"], j_icof)):
        assert (got.placed, got.rejected) == (want.placed, want.rejected)
        for f in ("p99_rt", "avg_rt"):
            assert getattr(got, f) == pytest.approx(getattr(want, f),
                                                    rel=1e-4), f
    # the widened gate opened: ICO-F placed otherwise than ICO
    assert row["icof"].p99_rt != row["ico"].p99_rt
    assert row["fallback_exact"] is True
    assert j_fb.p99_rt == j_ico.p99_rt
    assert tdoc["forecast"]["rows"][0]["fallback_exact"] is True
    # the port's axis was traced, JAX's was not: its rows follow
    assert [r[0] for r in tout[1:]] == ["torch." + r[0] for r in jout]
    assert tout[-1][2].split(";")[-1] == jout[-1][2].split(";")[-1]


def test_forecast_trace_reads_back(forecast, capsys):
    _, (tout, _, _, path) = forecast
    assert tout[0][0] == "torch.schedulers.forecast.trace"
    assert explain.main([path]) == 0
    assert capsys.readouterr().out.strip()


def test_benches_need_a_card_unless_told_otherwise(benches, monkeypatch):
    _, tb = benches
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        tb.run()
    for rel in ("benchmarks/bench_torch_scheduler_latency.py",
                "benchmarks/bench_torch_rollout_scale.py"):
        with pytest.raises(RuntimeError):
            _load(rel).run()
