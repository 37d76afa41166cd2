"""``benchmarks/bench_torch_scheduler_latency.py`` against JAX's
``bench_scheduler_latency``: the port's ``_fleet_view`` equals JAX's view
converted field for field, all five schedulers select JAX's nodes at
128 / 1,000 / 5,000 nodes, ICO and ICO-F score Eq. 4 on ``candidate_k``
rows past it, and the sweep's and ``--timers``' rows have JAX's shape.
No wall-clock bound is asserted here: on the CPU, beside other test
workers, one would be flaky; ``chip_smoke.py`` asserts JAX's 10x bound on
the card."""
import dataclasses
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.cluster.fleet import make_fleet
from repro_torch.cluster.view import ClusterView
from repro_torch.convert import view_from_numpy
from repro_torch.core import ICOScheduler, SchedulerConfig

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
SIZES = (128, 1000, 5000)


def _load(rel):
    path = ROOT / rel
    spec = importlib.util.spec_from_file_location(f"_bench_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def benches():
    return _load("benchmarks/bench_scheduler_latency.py"), _load(
        "benchmarks/bench_torch_scheduler_latency.py")


@pytest.fixture(scope="module")
def views(benches):
    jb, tb = benches
    return {n: (jb._fleet_view(n), tb._fleet_view(n, device=CPU))
            for n in SIZES}


def _same(a, b, name):
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype, name
        assert a.device == b.device and torch.equal(a, b), name
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    else:
        assert a == b, name


@pytest.mark.parametrize("n", SIZES)
def test_fleet_view_equals_jax_view(views, n):
    jview, tview = views[n]
    want = view_from_numpy(jview, device=CPU, fleet=make_fleet(n, seed=0))
    assert tview.num_nodes == n
    for f in dataclasses.fields(ClusterView):
        if f.init and f.name != "fleet":
            _same(getattr(tview, f.name), getattr(want, f.name), f.name)
    assert tview.fleet.class_names() == want.fleet.class_names()
    assert len(set(tview.node_class)) > 1   # heterogeneous


@pytest.mark.parametrize("n", SIZES)
def test_every_scheduler_selects_jax_node(benches, views, n):
    """Three calls of each fresh scheduler on one view (RR rotates), the
    same nodes as JAX's."""
    jb, tb = benches
    jview, tview = views[n]
    jpod, tpod = jb.Pod("web_search", 200.0, True), tb._pod()
    jpod.cpu_demand, jpod.mem_demand = tpod.cpu_demand, tpod.mem_demand
    jscheds, tscheds = jb._schedulers(), tb._schedulers()
    assert list(tscheds) == list(jscheds)
    for name in jscheds:
        want = [jscheds[name].select_node(jpod, jview) for _ in range(3)]
        got = [tscheds[name].select_node(tpod, tview) for _ in range(3)]
        assert got == want, name
        assert min(got) >= 0


def test_ico_scores_candidate_k_rows_at_5000(benches, views, monkeypatch):
    _, tb = benches
    _, tview = views[5000]
    rows = []
    exact = ICOScheduler._score_exact

    def spy(self, pod, view):
        rows.append((self.name, view.num_nodes))
        return exact(self, pod, view)

    monkeypatch.setattr(ICOScheduler, "_score_exact", spy)
    scheds = tb._schedulers()
    for name in ("ICO", "ICO-F"):
        assert scheds[name].select_node(tb._pod(), tview) >= 0
    k = SchedulerConfig().candidate_k
    assert rows == [("ICO", k), ("ICO-F", k)]


def test_sweep_selects_as_jax_sweep(benches):
    """The fast sweep (128 and 1,000 nodes, 20 repetitions after a warm
    call) of both benches: every row's selected node equal, every
    latency positive and finite."""
    jb, tb = benches
    jrows = jb.run(fast=True)
    sweep_doc: dict = {}
    trows = tb.run(fast=True, sweep_out=sweep_doc, device="cpu")
    assert [r[0] for r in trows] == ["torch." + r[0] for r in jrows]
    for j, t in zip(jrows, trows):
        assert t[2].split(";")[1] == j[2].split(";")[1], (t, j)
        assert np.isfinite(t[1]) and t[1] > 0
    assert set(sweep_doc) == {"ICO", "ICO-F", "HUP", "LQP", "RR"}
    for by_n in sweep_doc.values():
        assert set(by_n) == {"128", "1000"}
        for v in by_n.values():
            assert 0 < v["mean_us"] and 0 < v["p99_us"]


def test_phase_timers_rows(benches):
    """``--timers`` on the CPU, five windows: both rollout rows say they
    are one path, and the loop's phases are JAX's names."""
    _, tb = benches
    out: list = []
    res = tb.phase_timers(out, device=CPU, windows=5, reps=2)
    names = [r[0] for r in out]
    assert names[:2] == ["torch.scheduler_latency.rollout.python",
                         "torch.scheduler_latency.rollout.scanned"]
    assert all("same_path=True" in r[2] for r in out[:2])
    assert not any("speedup" in r[2] for r in out)
    phases = {n.rsplit(".", 1)[1] for n in names[2:]}
    assert {"rollout", "detect", "forecast"} <= phases
    assert res["phases"]["rollout"]["calls"] == 5
    assert all(r[1] > 0 for r in out if "rollout" in r[0])
