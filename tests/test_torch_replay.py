"""The port's plan recording and many-seed replay against
``repro.cluster.experiment``: ``run_experiment(plan_out=)`` and
``replay_plan_batched`` on the setup of ``tests/test_state.py::
_tiny_experiment`` (6 nodes, 12 pods, a linear predictor), with JAX's draws
injected; then the port's own reference-seed parity."""
import numpy as np
import pytest
import torch

from repro.cluster import experiment as jexp
from repro.core.interference import InterferenceQuantifier as JQuant
from repro.core.scheduler import ICOScheduler as JICO
from repro_torch.cluster import experiment as texp
from repro_torch.core.interference import InterferenceQuantifier as TQuant
from repro_torch.core.scheduler import ICOScheduler as TICO
from test_torch_noise import jax_noise_stream

NUM_NODES, SEED, SIM_SEEDS = 6, 5, (5, 6)
STATS = ("avg_rt", "p90_rt", "p99_rt", "cpu_util_std", "mem_util_std")


def _trace():
    return jexp._arrival_trace(12, seed=3)


def _port_sched():
    return TICO(TQuant(lambda x: x[:, 0] * 0.1))


def _port_run(plan_out=None, noise=None):
    pods, gaps = _trace()
    return texp.run_experiment(_port_sched(), pods, gaps,
                               num_nodes=NUM_NODES, seed=SEED, device="cpu",
                               noise=noise, plan_out=plan_out)


@pytest.fixture(scope="module")
def jax_side():
    """JAX's reference run with its plan, and its replay of that plan."""
    plan: dict = {}
    pods, gaps = _trace()
    ref = jexp.run_experiment(
        JICO(JQuant(lambda x: np.asarray(x)[:, 0] * 0.1)), pods, gaps,
        num_nodes=NUM_NODES, seed=SEED, plan_out=plan)
    return ref, plan, jexp.replay_plan_batched(plan, sim_seeds=SIM_SEEDS)


@pytest.fixture(scope="module")
def port_plan():
    plan: dict = {}
    res = _port_run(plan_out=plan, noise=jax_noise_stream(SEED, NUM_NODES))
    return res, plan


def test_plan_out_equals_jax(jax_side, port_plan):
    jref, jplan, _ = jax_side
    tref, tplan = port_plan
    assert (tref.placed, tref.rejected) == (jref.placed, jref.rejected)
    assert len(tplan["log"]) >= tref.placed > 0
    assert tplan["log"] == jplan["log"]
    for k in ("t_end", "num_nodes", "seed", "settle_ticks", "fleet"):
        assert tplan[k] == jplan[k], k


@pytest.mark.parametrize("fused", [False, True])
def test_replay_matches_jax_with_its_draws(jax_side, port_plan, fused):
    """Both tick paths against JAX's default replay: per-seed statistics
    within 1e-4, hot-window counts and geometry exact."""
    _, _, want = jax_side
    _, tplan = port_plan
    got = texp.replay_plan_batched(
        tplan, sim_seeds=SIM_SEEDS, use_fused=fused, device="cpu",
        noise=[jax_noise_stream(s, NUM_NODES) for s in SIM_SEEDS])
    for k in ("num_windows", "padded_windows"):
        assert got[k] == want[k], k
    assert got["padded_windows"] > got["num_windows"]   # bucketing padded
    assert got["wall_s"] > 0
    for g, w in zip(got["seeds"], want["seeds"]):
        assert g["sim_seed"] == w["sim_seed"]
        assert g["hot_windows"] == w["hot_windows"]
        for k in STATS:
            assert g[k] == pytest.approx(w[k], rel=1e-4), (k, g, w)


def test_reference_seed_reproduces_the_run_on_the_ports_generator():
    """No JAX draws: the entry under the run's own seed is that run (the
    replay draws what ``Cluster(seed=5)`` draws); another seed is not."""
    plan: dict = {}
    ref = _port_run(plan_out=plan)
    out = texp.replay_plan_batched(plan, sim_seeds=SIM_SEEDS, use_fused=True,
                                   device="cpu")
    by_seed = {e["sim_seed"]: e for e in out["seeds"]}
    for k in ("avg_rt", "p90_rt", "p99_rt"):
        assert by_seed[SEED][k] == pytest.approx(getattr(ref, k), rel=1e-3), k
    assert by_seed[6]["avg_rt"] != by_seed[SEED]["avg_rt"]


def test_run_experiment_batched_on_cpu():
    pods, gaps = _trace()
    ref, batch = texp.run_experiment_batched(
        _port_sched(), pods, gaps, num_nodes=NUM_NODES, seed=SEED,
        sim_seeds=(SEED,), device="cpu")
    assert [e["sim_seed"] for e in batch["seeds"]] == [SEED]
    assert batch["seeds"][0]["p99_rt"] == pytest.approx(ref.p99_rt, rel=1e-3)


def test_replay_rebuilds_a_fleet_plan():
    """A fleet run's plan carries its fleet: the replay starts from its
    per-node capacities and delay curves."""
    from repro_torch.cluster.fleet import make_fleet

    fleet = make_fleet(8, {"std32": 1, "hi96": 1}, seed=0)
    pods, gaps = _trace()
    plan: dict = {}
    texp.run_experiment(_port_sched(), pods[:4], gaps[:4], fleet=fleet,
                        seed=1, device="cpu", plan_out=plan)
    assert plan["num_nodes"] == 8 and plan["fleet"] is fleet
    inp = texp.replay_inputs(plan, device="cpu")
    np.testing.assert_array_equal(inp["state"].cpu_sum.numpy(),
                                  fleet.cores().astype(np.float32))
    torch.testing.assert_close(inp["fleet"].delay_scale,
                               fleet.params(device="cpu").delay_scale)
    out = texp.replay_plan_batched(plan, sim_seeds=(1,), device="cpu")
    assert np.isfinite(out["seeds"][0]["avg_rt"])
