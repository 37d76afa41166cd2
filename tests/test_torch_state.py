"""The port's cluster state, transforms, rollout and shell against
``repro.cluster`` on the same inputs (JAX draws injected as noise bundles)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cluster import fleet as jfleet
from repro.cluster import state as jstate
from repro.cluster.simulator import Cluster as JCluster
from repro_torch.cluster import fleet as tfleet
from repro_torch.cluster import state as tstate
from repro_torch.cluster.simulator import Cluster as TCluster
from repro_torch.cluster.workloads import Pod
from repro_torch.convert import state_from_numpy
from repro_torch.device import resolve_device
from test_torch_noise import (
    CPU,
    assert_outputs_close,
    assert_state_equal,
    jax_noise_stream,
    jax_profiles,
    jax_window_noise,
    loaded_jax_state,
)


def _transforms(mod, st):
    """The same transform sequence on either package's state."""
    st = mod.place_online(st, 0, 1, 2, 321.5, 1.25)
    st = mod.place_online(st, 3, 0, 1, 99.0, 4.5)
    st = mod.place_offline(st, 1, 2, 8.0, 12.8, 20.0, 1.7, 30)
    st = mod.place_offline(st, 4, 0, 4.0, 6.4, 10.0, 0.9, 7)
    st = mod.migrate_online(st, 0, 1, 2, 5)
    st = mod.migrate_offline(st, 1, 2, 5, 3)
    st = mod.resize_online(st, 2, 5, 150.25)
    st = mod.resize_offline(st, 5, 3, 2.0, 3.2, 5.0, 60)
    st = mod.evict_online(st, 3, 0)
    st = mod.evict_offline(st, 4, 0)
    st = st.replace(off_active=st.off_active & False)  # the tick expired them
    return mod.reconcile(st)


def test_transforms_exact_against_jax():
    jst = loaded_jax_state()
    tst = state_from_numpy(jst, device=CPU)
    jst, jstale = _transforms(jstate, jst)
    tst, tstale = _transforms(tstate, tst)
    assert_state_equal(tst, jst)
    np.testing.assert_array_equal(tstale.numpy(), np.asarray(jstale))


def test_transforms_leave_their_argument_alone():
    st = tstate.ClusterState.create(3, device=CPU)
    before = {k: v.clone() for k, v in vars(st).items()}
    tstate.migrate_online(tstate.place_online(st, 0, 0, 1, 10.0, 0.5),
                          0, 0, 1, 1)
    for k, v in vars(st).items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0)


def test_state_from_numpy_round_trip():
    jst = loaded_jax_state()
    tst = state_from_numpy(jst, device=CPU)
    assert tst.on_active.dtype == torch.bool
    assert tst.on_type.dtype == torch.int32
    assert tst.off_remaining.dtype == torch.int32
    assert_state_equal(tst, jst)
    jf = jfleet.make_fleet(20, seed=3).params()
    tf = state_from_numpy(jf, device=CPU)
    for f in dataclasses.fields(tstate.FleetParams):
        np.testing.assert_array_equal(getattr(tf, f.name).numpy(),
                                      np.asarray(getattr(jf, f.name)))
    prof = state_from_numpy(jax_profiles(), device=CPU)
    for k, v in jax_profiles().items():
        np.testing.assert_array_equal(prof[k].numpy(), np.asarray(v))


def test_fleet_params_uniform_is_the_homogeneous_fleet():
    uni = tstate.FleetParams.uniform(7, device=CPU)
    homo = tfleet.Fleet.homogeneous(7).params(device=CPU)
    juni = jstate.FleetParams.uniform(7)
    for f in dataclasses.fields(tstate.FleetParams):
        a = getattr(uni, f.name)
        assert a.dtype == torch.float32
        torch.testing.assert_close(a, getattr(homo, f.name), rtol=0, atol=0)
        np.testing.assert_array_equal(a.numpy(), np.asarray(getattr(juni, f.name)))


def test_make_fleet_matches_jax():
    t = tfleet.make_fleet(100, {"std32": 6, "hi96": 1, "lo16": 3}, seed=0)
    j = jfleet.make_fleet(100, {"std32": 6, "hi96": 1, "lo16": 3}, seed=0)
    assert t.class_names() == j.class_names()
    np.testing.assert_array_equal(t.cores(), j.cores())
    for k, v in j.delay_params64().items():
        np.testing.assert_array_equal(t.delay_params64()[k], v)
    np.testing.assert_array_equal(t.topology.rack_of, j.topology.rack_of)
    assert t.topology.transfer_cost(0, 99, 2.0) == j.topology.transfer_cost(0, 99, 2.0)


def test_rollout_chunks_window_matches_jax():
    """Two chunks on the same state with JAX's draws: the state is exact,
    merged floats allclose, histogram totals exact."""
    jst = loaded_jax_state()
    tst = state_from_numpy(jst, device=CPU)
    profiles, fleet = jax_profiles(), jstate.FleetParams.uniform(jst.num_nodes)
    _, keys = jstate.chunk_key_stream(jax.random.PRNGKey(9), 2)
    jfinal, stacked = jstate.rollout_chunks(jst, profiles, fleet, 100.0, keys)
    stacked = jax.tree.map(np.asarray, stacked)
    jmerged = jstate.merge_summaries(
        [jax.tree.map(lambda a, i=i: a[i], stacked) for i in range(2)])

    noise = iter([jax_window_noise(k, jst.num_nodes) for k in keys])
    tfinal, parts = tstate.rollout_chunks(
        tst, state_from_numpy(profiles, device=CPU),
        state_from_numpy(fleet, device=CPU), 100.0, 2, noise)
    tmerged = tstate.merge_summaries(parts)
    assert_state_equal(tfinal, jfinal)
    assert set(tmerged) == set(jmerged)
    assert tmerged["rt"].shape == jmerged["rt"].shape == (20, 6, 8)
    assert_outputs_close(tmerged, jmerged)


def _pods():
    on = Pod("web_search", 300.0, True)
    on.cpu_demand, on.mem_demand = 7.4, 5.3
    off = Pod("graph_analytics", 0.0, False, duration=45)
    off.cpu_demand, off.mem_demand = 8.0, 14.4
    on2 = Pod("data_caching", 500.0, True)
    on2.cpu_demand, on2.mem_demand = 3.3, 12.0
    return [(on, 0), (off, 1), (on2, 1),
            (dataclasses.replace(off, duration=35), 3)]


def _shell(cls, **kw):
    c = cls(num_nodes=4, seed=5, **kw)
    for pod, node in _pods():
        assert c.place(dataclasses.replace(pod), node)
    return c


def test_shell_matches_jax_cluster():
    """Same placements, uid map and mutation log; the same telemetry when
    JAX's chunk key stream is replayed as noise."""
    j = _shell(JCluster)
    t = _shell(TCluster, device="cpu", noise=jax_noise_stream(5, 4))
    for c in (j, t):
        c.rollout(20)
        c.migrate(0, 2)
        c.resize(1, cores=4.0)
        c.rollout(30)                 # the offline job on node 3 ends
    assert t.log == j.log
    assert t._pod_slots == j._pod_slots
    np.testing.assert_array_equal(t.slot_uids(), j.slot_uids())
    assert_state_equal(t.state, j.state)
    assert_outputs_close(t.last, j.last)
    np.testing.assert_allclose(t.online_rt_samples().numpy(),
                               j.online_rt_samples(), rtol=1e-5)
    assert 3 not in t._pod_slots      # reconciled away on both sides


def test_rollout_scan_is_rollout_bitwise():
    a, b = _shell(TCluster, device="cpu"), _shell(TCluster, device="cpu")
    for _ in range(2):
        sa, sb = a.rollout(25), b.rollout_scan(25)
        for k in sa:
            torch.testing.assert_close(sa[k], sb[k], rtol=0, atol=0)
        for c in (a, b):
            c.migrate(0, 3)
    for k, v in vars(a.state).items():
        torch.testing.assert_close(v, getattr(b.state, k), rtol=0, atol=0)
    assert a.t == b.t == 60.0


def test_entry_points_default_to_the_card():
    """``device=None`` means CUDA; without a card it raises, never falls
    back to the CPU."""
    if torch.cuda.is_available():
        assert TCluster(num_nodes=2).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        TCluster(num_nodes=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    assert resolve_device("cpu") == CPU


def test_topk_candidates_ties_lowest_index_like_jax():
    """On an empty fleet every node of a class ties exactly; both packages
    keep the lowest indices."""
    f = jfleet.make_fleet(100, {"std32": 6, "hi96": 1, "lo16": 3}, seed=0)
    cores = f.cores().astype(np.float32)
    mem = f.mem_gb().astype(np.float32)
    cur = np.full(100, 0.5, np.float32)
    mcur = np.full(100, 2.0, np.float32)
    mcur[[5, 17]] = 200.0                     # two infeasible nodes
    args = (cur, cores, mcur, mem)
    jidx, jvals = jfleet.topk_candidates(
        *map(jnp.asarray, args), jnp.float32(1.2 * 4.0),
        jnp.float32(1.2 * 6.0), 0.7, 0.8, 64)
    tidx, tvals = tfleet.topk_candidates(
        *map(torch.from_numpy, args), torch.tensor(1.2 * 4.0),
        torch.tensor(1.2 * 6.0), 0.7, 0.8, 64)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(tvals.numpy(), np.asarray(jvals))
    # and with fewer feasible nodes than k, -inf padding in the same order
    mcur[:50] = 200.0
    jidx, _ = jfleet.topk_candidates(
        *map(jnp.asarray, (cur, cores, mcur, mem)), jnp.float32(4.8),
        jnp.float32(7.2), 0.7, 0.8, 64)
    tidx, _ = tfleet.topk_candidates(
        *map(torch.from_numpy, (cur, cores, mcur, mem)), torch.tensor(4.8),
        torch.tensor(7.2), 0.7, 0.8, 64)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
