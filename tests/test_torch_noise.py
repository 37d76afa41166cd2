"""JAX-drawn tick noise for the port, and the tick parity it gives.

``repro.cluster.state._tick`` draws every random number it needs from one
per-tick key (``state.py`` l.501-603).  ``jax_tick_noise`` repeats that
exact ``split``/``fold_in`` sequence and hands the draws to the port as a
``TickNoise`` bundle; ``jax_noise_stream`` repeats ``Cluster``'s per-chunk
key stream (``key, k = split(key)`` per chunk, ``split(k, CHUNK)`` per
tick).  Fed these bundles, the port computes on the same random inputs as
the JAX package, which is what the other ``test_torch_*`` parity tests
rely on.  This file also holds the tick-level parity test.
"""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cluster import state as jstate
from repro.cluster import workloads as JW
from repro_torch.cluster import state as tstate
from repro_torch.convert import state_from_numpy

CPU = torch.device("cpu")


def _tick_draws(key, num_nodes: int) -> dict:
    """The draws of one ``_tick`` from its key, in ``_tick``'s order."""
    k_qps, k_lat, k_rt, k_hw = jax.random.split(key, 4)
    tiny = jnp.finfo(jnp.float32).tiny

    def pod(k, n_slots):
        jit_ = jax.random.normal(jax.random.fold_in(k, 0), (num_nodes, n_slots))
        u = jax.random.uniform(
            jax.random.fold_in(k, 1),
            (num_nodes, n_slots, jstate.SAMPLES_PER_TICK, 2),
            minval=tiny, maxval=1.0)
        return jit_, u

    jit_on, u_on = pod(jax.random.fold_in(k_lat, 0), jstate.S_ON)
    jit_off, u_off = pod(jax.random.fold_in(k_lat, 1), jstate.S_OFF)
    return dict(
        qps=jax.random.normal(k_qps, (num_nodes, jstate.S_ON)),
        delay=jax.random.normal(jax.random.fold_in(k_lat, 99), (num_nodes,)),
        jit_on=jit_on, jit_off=jit_off, u_on=u_on, u_off=u_off,
        rt=jax.random.normal(k_rt, (num_nodes, jstate.S_ON)),
        hw=jax.random.normal(k_hw, (num_nodes, 8)),
    )


@partial(jax.jit, static_argnames=("num_nodes", "num_ticks"))
def _window_draws(key, num_nodes: int, num_ticks: int) -> dict:
    # _window_core splits its key into one key per tick
    keys = jax.random.split(key, num_ticks)
    return jax.vmap(lambda k: _tick_draws(k, num_nodes))(keys)


def _bundle(draws: dict, i=None) -> tstate.TickNoise:
    pick = (lambda a: a) if i is None else (lambda a: a[i])
    return tstate.TickNoise(**{
        k: torch.as_tensor(np.array(pick(v))) for k, v in draws.items()})


_tick_draws_jit = jax.jit(_tick_draws, static_argnums=1)


def jax_tick_noise(key, num_nodes: int) -> tstate.TickNoise:
    """The ``TickNoise`` JAX ``_tick(..., key)`` draws, as CPU tensors."""
    return _bundle(_tick_draws_jit(key, num_nodes))


def jax_window_noise(key, num_nodes: int,
                     num_ticks: int = jstate.CHUNK) -> list:
    """The bundles of JAX ``_window_core(..., key, num_ticks)``, per tick."""
    draws = jax.tree.map(np.asarray, _window_draws(key, num_nodes, num_ticks))
    return [_bundle(draws, i) for i in range(num_ticks)]


def jax_noise_stream(seed: int, num_nodes: int):
    """Endless per-chunk bundles, as ``repro`` ``Cluster(seed=seed)`` draws
    them: the port's ``Cluster(noise=...)`` then replays JAX's randomness."""
    key = jax.random.PRNGKey(seed)
    while True:
        key, k = jax.random.split(key)
        yield jax_window_noise(k, num_nodes)


# --------------------------------------------------------------------------
# shared comparison helpers (used by the other parity files too)
# --------------------------------------------------------------------------

FLOAT_TOL = dict(rtol=1e-5, atol=1e-5)
# samples are -log(U1*U2) * mean / 2; XLA's and torch's log may differ in
# the last ulp, which moves a sample only when it lies within a few ulps
# of a 5-unit bin edge -- a handful of samples per thousand windows
MAX_EDGE_MOVES = 4


def assert_hist_close(got: torch.Tensor, want, max_moves=MAX_EDGE_MOVES):
    """Equal per-series totals; per-bin counts equal up to edge moves."""
    got = got.numpy()
    want = np.asarray(want)
    np.testing.assert_array_equal(got.sum(-1), want.sum(-1))
    moved = np.abs(got - want).sum() / 2
    assert moved <= max_moves, f"{moved} samples changed bin"


def assert_state_equal(got: tstate.ClusterState, want):
    for f in dataclasses.fields(tstate.ClusterState):
        np.testing.assert_array_equal(
            getattr(got, f.name).numpy(), np.asarray(getattr(want, f.name)),
            err_msg=f.name)


def assert_outputs_close(got: dict, want: dict, keys=None):
    for k in keys or got:
        if k.startswith("hist"):
            assert_hist_close(got[k], want[k])
        else:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       err_msg=k, **FLOAT_TOL)


def loaded_jax_state(num_nodes=6, seed=3):
    """A JAX ``ClusterState`` with online and offline pods on most nodes,
    built from the pure transforms with numpy-drawn parameters."""
    rng = np.random.default_rng(seed)
    st = jstate.ClusterState.create(num_nodes)
    for n in range(num_nodes - 1):  # the last node stays empty
        for s in range(int(rng.integers(1, jstate.S_ON))):
            st = jstate.place_online(
                st, n, s, int(rng.integers(0, 4)), float(rng.uniform(50, 900)),
                float(rng.uniform(0, 2 * np.pi)))
        for s in range(int(rng.integers(0, jstate.S_OFF))):
            cores = float(rng.choice([2, 4, 8]))
            st = jstate.place_offline(
                st, n, s, cores, 1.6 * cores, 2.5 * cores,
                float(rng.uniform(0.7, 2.1)), int(rng.integers(1, 15)))
    return st


def jax_profiles():
    return {k: jnp.asarray(v) for k, v in JW.online_arrays().items()}


# --------------------------------------------------------------------------
# the helper itself
# --------------------------------------------------------------------------


def test_bundle_shapes_and_ranges():
    noise = jax_tick_noise(jax.random.PRNGKey(0), 6)
    assert noise.qps.shape == (6, jstate.S_ON)
    assert noise.delay.shape == (6,)
    assert noise.u_on.shape == (6, jstate.S_ON, jstate.SAMPLES_PER_TICK, 2)
    assert noise.u_off.shape == (6, jstate.S_OFF, jstate.SAMPLES_PER_TICK, 2)
    assert noise.hw.shape == (6, 8)
    for u in (noise.u_on, noise.u_off):
        assert u.dtype == torch.float32
        assert float(u.min()) >= float(np.finfo(np.float32).tiny)
        assert float(u.max()) < 1.0


def test_window_noise_matches_per_tick_keys():
    """The vmapped window draw equals one draw per split tick key."""
    key = jax.random.PRNGKey(11)
    window = jax_window_noise(key, 6)
    for i, k in enumerate(jax.random.split(key, jstate.CHUNK)[:3]):
        one = jax_tick_noise(k, 6)
        for f in dataclasses.fields(tstate.TickNoise):
            torch.testing.assert_close(getattr(window[i], f.name),
                                       getattr(one, f.name), rtol=0, atol=0)


def test_noise_stream_follows_chunk_key_stream():
    stream = jax_noise_stream(5, 6)
    _, keys = jstate.chunk_key_stream(jax.random.PRNGKey(5), 2)
    for c in range(2):
        got = next(stream)
        want = jax_window_noise(keys[c], 6)
        for a, b in zip(got, want):
            torch.testing.assert_close(a.u_on, b.u_on, rtol=0, atol=0)
            torch.testing.assert_close(a.rt, b.rt, rtol=0, atol=0)


@pytest.mark.parametrize("t", [0.0, 1234.0])
def test_port_tick_matches_jax_tick(t):
    """One tick on the same state with JAX's own draws: the new state is
    exact, floats agree to allclose, histogram totals are exact."""
    st = loaded_jax_state()
    profiles = jax_profiles()
    fleet = jstate.FleetParams.uniform(st.num_nodes)
    key = jax.random.PRNGKey(42)
    jst, jout = jax.jit(jstate._tick)(st, profiles, fleet, jnp.float32(t), key)

    tst, tout = tstate._tick(
        state_from_numpy(st, device=CPU), state_from_numpy(profiles, device=CPU),
        state_from_numpy(fleet, device=CPU), torch.tensor(t),
        noise=jax_tick_noise(key, st.num_nodes))
    assert_state_equal(tst, jst)
    assert set(tout) == set(jout)
    assert_outputs_close(tout, jout)
    assert float(tout["hist_on"].sum()) > 0 and float(tout["hist_off"].sum()) > 0
