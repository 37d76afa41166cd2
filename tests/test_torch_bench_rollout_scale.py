"""``benchmarks/bench_torch_rollout_scale.py`` against JAX's
``bench_rollout_scale``: the same synthetic plans and ``extract_plan``
events, JAX's per-seed draws checked against its chunk keys, and the
``vmap`` row's per-seed p99 equal to JAX's ``_seed_p99`` with those draws
injected (the port's fused tick against JAX's default tick)."""
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from test_torch_noise import jax_noise_stream, jax_window_noise


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the module's tests: under the suite's
    several worker processes, torch's default of one thread a core in each
    makes their small CPU kernels spin against each other, and alone on an
    8-core CPU the module took 13 s at one thread against 15 s at eight."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
DAYS, NODES, SEEDS = 0.05, 12, (0, 1)


def _load(rel):
    path = ROOT / rel
    spec = importlib.util.spec_from_file_location(f"_bench_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def benches():
    return _load("benchmarks/bench_rollout_scale.py"), _load(
        "benchmarks/bench_torch_rollout_scale.py")


@pytest.fixture(scope="module")
def jax_row(benches):
    """JAX's scenario and ``vmap`` engine row at 0.05 day, 12 nodes, two
    seeds (its ``SIM_SEEDS`` set for the fixture's lifetime)."""
    jb, _ = benches
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jb, "SIM_SEEDS", SEEDS)
        sc = jb._build_scenario(NODES, DAYS)
        row, p99 = jb._time_engine(sc, devices=None)
    return sc, row, p99


@pytest.mark.parametrize("nodes,days", [(12, 3.0), (1000, 0.1)])
def test_synthetic_plan_and_events_equal_jax(benches, nodes, days):
    """The log and its ``extract_plan`` events, as JAX's
    ``_build_scenario`` buckets them (the same library call)."""
    from repro.cluster import state as jstate

    jb, tb = benches
    log, t_end = tb._synthetic_plan(nodes, days)
    assert (log, t_end) == jb._synthetic_plan(nodes, days)
    assert len(log) > 2 * nodes
    sc = tb.build_scenario(nodes, days, device=CPU)
    cpw = max(1, jb.WINDOW_TICKS // jstate.CHUNK)
    assert sc["num_windows"] == -(-(t_end // jstate.CHUNK) // cpw)
    want = jstate.extract_plan(log, 0.0, sc["num_windows"], cpw)
    assert set(sc["events"]) == set(want)
    for k, v in sc["events"].items():
        np.testing.assert_array_equal(np.asarray(v), np.asarray(want[k]),
                                      err_msg=k)
    assert sc["seeds"] == (jb.SIM_SEEDS if nodes <= 100 else jb.SAMPLE_SEEDS)


def test_injected_draws_follow_the_scenarios_keys(jax_row):
    """JAX's scenario keys (``chunk_key_stream(PRNGKey(s))``) give the
    draws ``jax_noise_stream(s, N)`` yields, chunk for chunk."""
    sc, _, _ = jax_row
    keys = np.asarray(sc["keys"]).reshape(len(SEEDS), -1, 2)
    for b, s in enumerate(SEEDS):
        stream = jax_noise_stream(s, NODES)
        for c in range(keys.shape[1]):
            got = next(stream)
            want = jax_window_noise(keys[b, c], NODES)
            for g, w in zip(got, want):
                torch.testing.assert_close(g.u_on, w.u_on, rtol=0, atol=0)
                torch.testing.assert_close(g.qps, w.qps, rtol=0, atol=0)


def test_vmap_row_p99_equals_jax_with_its_draws(benches, jax_row):
    _, tb = benches
    sc_j, row_j, p99_j = jax_row
    sc = tb.build_scenario(NODES, DAYS, device=CPU, noise=jax_noise_stream,
                           seeds=SEEDS)
    assert sc["num_windows"] == sc_j["num_windows"]
    assert sc["t_end"] == sc_j["t_end"]
    row, p99 = tb.time_engine(sc)
    assert len(p99) == len(p99_j) == len(SEEDS)
    np.testing.assert_allclose(p99, p99_j, rtol=1e-4)
    assert p99[0] != p99[1]
    for k in ("cold_s", "warm_s", "windows_per_s", "node_ticks_per_s"):
        assert row[k] > 0 and set(row) == set(row_j)


def test_scenario_row_on_the_cpu(benches):
    """A 12-node row through ``scenario_row`` on the port's own generator:
    JAX's row fields, a finite p99 per seed, the CSV row's name."""
    _, tb = benches
    out, rows = [], []
    rec, p99 = tb.scenario_row(DAYS, NODES, device=CPU, out=out, rows=rows)
    assert rows == [rec] and rec["seeds"] == len(tb.SIM_SEEDS)
    assert rec["engine"] == "vmap" and not rec["scaled_sample"]
    assert out[0][0] == "torch.rollout_scale_0.05day_12n_vmap"
    assert "node_ticks_per_s=" in out[0][2] and out[0][1] > 0
    assert np.isfinite(p99).all() and len(set(p99)) > 1
