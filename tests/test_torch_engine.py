"""The port's batched replay engine against ``repro.cluster.state``: event
plans, event replay, the folded detector and forecaster steps, the window
scan and ``batched_rollout`` on both tick paths, with JAX's draws injected
(``test_torch_noise.jax_noise_stream``); then the engine's own invariants
with the port's generator."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cluster import state as jstate
from repro.control import detector as jdet
from repro.control import forecast as jfc
from repro_torch.cluster import state as tstate
from repro_torch.control import detector as tdet
from repro_torch.control import forecast as tfc
from repro_torch.convert import fold_from_numpy, state_from_numpy
from test_torch_noise import (
    CPU,
    FLOAT_TOL,
    assert_state_equal,
    jax_noise_stream,
    jax_profiles,
    loaded_jax_state,
)

# one event of every kind, over two chunks, on loaded_jax_state()'s 6 nodes
ALL_OPS_LOG = [
    ("place_on", 0.0, 5, 0, 2, 321.5, 1.25),
    ("place_off", 0.0, 5, 1, 8.0, 12.8, 20.0, 1.7, 30),
    ("migrate_on", 0.0, 5, 0, 4, 7),
    ("migrate_off", 0.0, 5, 1, 3, 5),
    ("resize_on", 0.0, 4, 7, 150.25),
    ("resize_off", 0.0, 3, 5, 2.0, 3.2, 5.0, 0.0, 60),
    ("evict_on", 10.0, 0, 0),
    ("evict_off", 10.0, 1, 0),
]

# the engine scenario: test_engine._scenario's shape (B = 3 seeds, N = 3
# nodes), four 2-chunk windows, with enough load that node 1 runs hot
N, SEEDS, W, CPW = 3, (0, 1, 2), 4, 2
SCENARIO_LOG = [
    ("place_on", 0.0, 0, 0, 0, 300.0, 0.4),
    ("place_on", 0.0, 0, 1, 1, 250.0, 2.2),
    ("place_on", 0.0, 1, 0, 2, 420.0, 1.0),
    ("place_off", 10.0, 1, 0, 16.0, 25.6, 40.0, 2.0, 45),
    ("place_off", 10.0, 1, 1, 8.0, 12.8, 20.0, 1.8, 200),
    ("place_on", 20.0, 2, 0, 3, 180.0, 0.7),
    ("migrate_on", 40.0, 0, 1, 2, 3),
    ("resize_on", 50.0, 2, 0, 260.0),
    ("evict_on", 60.0, 0, 0),
]
OUT_KEYS = ("rt", "qps", "cpu_util", "mem_util", "hot")


def _jax_keys(seeds, windows, cpw=CPW):
    return jnp.stack([
        jstate.chunk_key_stream(jax.random.PRNGKey(s), windows * cpw)[1]
        .reshape(windows, cpw, -1) for s in seeds])


def _port_profiles():
    return state_from_numpy(jax_profiles(), device=CPU)


def _assert_outs(got: dict, want: dict):
    np.testing.assert_array_equal(got["hot"].numpy(), np.asarray(want["hot"]))
    for k in ("rt", "qps", "cpu_util", "mem_util"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **FLOAT_TOL)


def _assert_outs_equal(got: dict, want: dict, sl=slice(None)):
    for k in OUT_KEYS:
        torch.testing.assert_close(got[k][:, sl], want[k], rtol=0, atol=0,
                                   msg=k)


# ------------------------------------------------------------ event replay


@pytest.mark.parametrize("bucket", [False, True])
def test_extract_plan_arrays_equal_jax(bucket):
    want = jstate.extract_plan(ALL_OPS_LOG, 0.0, 3, 2, bucket=bucket)
    got = tstate.extract_plan(ALL_OPS_LOG, 0.0, 3, 2, bucket=bucket)
    assert got["op"].shape == ((4, 2, 8) if bucket else (3, 2, 6))
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_extract_plan_refuses_events_outside_the_span():
    with pytest.raises(ValueError, match="outside the planned span"):
        tstate.extract_plan([("evict_on", 40.0, 0, 0)], 0.0, 1, 2)


def test_apply_events_state_equals_jax():
    """Every op kind, two chunks; also on two seeds at once (batch=2)."""
    events = tstate.extract_plan(ALL_OPS_LOG, 0.0, 1, 2)
    jst = loaded_jax_state()
    tst = state_from_numpy(jst, device=CPU)
    two = tstate.ClusterState(**{k: torch.cat([v, v])
                                 for k, v in vars(tst).items()})
    for c in range(2):
        chunk = {k: v[0, c] for k, v in events.items()}
        jst = jstate.apply_events(jst, {k: jnp.asarray(v)
                                        for k, v in chunk.items()})
        tst = tstate.apply_events(tst, chunk)
        two = tstate.apply_events(two, chunk, batch=2)
    assert_state_equal(tst, jst)
    n = tst.num_nodes
    for k, v in vars(two).items():
        torch.testing.assert_close(v[:n], getattr(tst, k), rtol=0, atol=0)
        torch.testing.assert_close(v[n:], getattr(tst, k), rtol=0, atol=0)


# --------------------------------------------------- detector and forecaster


@pytest.mark.parametrize("steps", [0, 1, 4])
def test_node_track_step_matches_jax(steps):
    """Flags exact, floats allclose; rows built to trip each channel."""
    rng = np.random.default_rng(steps)
    r = 8
    hist = rng.integers(0, 30, (r, 200)).astype(np.float32)
    node_hists = rng.integers(0, 20, (r, 200)).astype(np.float32)
    node_hists[:3, 150:] += 40.0                       # acute tail
    mu = rng.uniform(10.0, 40.0, r).astype(np.float32)
    cusum = rng.uniform(0.0, 90.0, r).astype(np.float32)
    cfg = tdet.DetectorConfig()
    args = (cfg.decay, cfg.baseline_alpha, cfg.slack, cfg.drift_threshold,
            cfg.quantile, cfg.abs_threshold, cfg.warmup)
    want = jdet.node_track_step(hist, mu, cusum, steps, node_hists, *args)
    got = tdet.node_track_step(*(torch.as_tensor(a) for a in (
        hist, mu, cusum)), steps, torch.as_tensor(node_hists), *args)
    assert len(got) == len(want) == 10
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        if w.dtype == bool:
            np.testing.assert_array_equal(g.numpy(), w, err_msg=str(i))
        else:
            np.testing.assert_allclose(g.numpy(), w, err_msg=str(i),
                                       **FLOAT_TOL)
    hot = got[-1].numpy()
    assert hot.any() == (steps >= cfg.warmup)


def _streaming_outputs(cfg):
    """Proactive mask and attribution of a StreamingDetector fed a slot
    arrival and a forecast drift, for the two fields only it reads."""
    det = tdet.StreamingDetector(2, cfg, device="cpu")
    pro = []
    for i in range(6):
        hists = np.zeros((2, 3, 200), np.float32)
        hists[:, 0, 4] = 64.0                    # both nodes calm at 20
        if i >= 3:
            hists[0, 2, 6] = 64.0                # an arrival at 30
            hists[1, 0] = 0.0
            hists[1, 0, 8] = 64.0                # node 1 rises to 40 ...
        fc = np.array([-1e9, 400.0 if i >= 3 else -1e9], np.float32)
        det.update(hists, fc)                    # ... as forecast
        pro.append(det.last_proactive.tolist())
    return pro, det.attribution().tolist()


def _service_outputs(cfg):
    """Gates and projection of a ForecastService for the fields only the
    service reads: node 0's pod is fitted over most of a period (trusted,
    its forecast pressure clamped), node 1's arrived late (its short arc
    fails the leverage gate)."""
    from repro_torch.cluster.view import ClusterView

    svc = tfc.ForecastService(cfg, device="cpu")
    rng = np.random.default_rng(0)
    for k in range(60):
        t = 30.0 + 40.0 * k
        qps = 900.0 * (1 + 0.35 * np.sin(2 * np.pi * t / 2880.0 + 0.3)
                       + 0.02 * rng.standard_normal(2))
        hists = torch.zeros((2, 1, 200))
        hists[:, 0, 4] = 64.0
        view = ClusterView(
            t=t, online_qps=torch.tensor(qps[:, None], dtype=torch.float32),
            on_active=torch.tensor([[True], [k >= 50]]),
            on_type=torch.zeros((2, 1), dtype=torch.int32),
            off_pressure=torch.zeros(2), cpu_sum=torch.full((2,), 32.0),
            slot_hists=hists, slot_uids=np.zeros((2, 1), np.int64))
        svc.observe(view)
    svc.horizon = 30.0
    proj = svc.project(view)
    gated = (proj.delta >= cfg.min_predicted_drift).tolist()
    return (proj.trusted.tolist(), proj.rho.tolist(), proj.delta.tolist(),
            gated)


# a value of each service-only field that must change _service_outputs
_SERVICE_PROBES = {"min_windows": 1000, "max_rel_err": 1e-3,
                   "max_leverage": 5.0, "rho_cap": 5.0,
                   "min_predicted_drift": 1e4}


def test_detector_config_matches_jax():
    """Each field of the port's configs has JAX's default and changes what
    ``fold_configs`` hands the window scan or, for the fields only the
    streaming detector or the forecast service reads, what that detector
    flags and attributes or what the service projects and passes on (no
    field is inert)."""
    assert ([f.name for f in dataclasses.fields(tdet.DetectorConfig)]
            == [f.name for f in dataclasses.fields(jdet.DetectorConfig)])
    streaming_only = {"proactive_threshold", "attribution_floor"}
    base = tstate.fold_configs()
    base_streaming = _streaming_outputs(tdet.DetectorConfig())
    base_service = _service_outputs(tfc.ForecastConfig())
    for i, (port_cls, jax_cfg) in enumerate(
            ((tdet.DetectorConfig, jdet.DetectorConfig()),
             (tfc.ForecastConfig, jfc.ForecastConfig()))):
        for f in dataclasses.fields(port_cls):
            default = getattr(port_cls(), f.name)
            assert default == getattr(jax_cfg, f.name), f.name
            if f.name in streaming_only:
                cfg = port_cls(**{f.name: default * 8})
                assert _streaming_outputs(cfg) != base_streaming, f.name
                continue
            if f.name in _SERVICE_PROBES:
                cfg = port_cls(**{f.name: _SERVICE_PROBES[f.name]})
                assert _service_outputs(cfg) != base_service, f.name
                continue
            cfg = port_cls(**{f.name: default + 1})
            got = tstate.fold_configs(**{("det_cfg", "fc_cfg")[i]: cfg})
            assert got[i] != base[i], f.name
    assert tfc.NUM_FEATURES == jfc.NUM_FEATURES
    assert tfc.TICKS_PER_DAY == jstate.TICKS_PER_DAY


@pytest.mark.parametrize("t", [40.0, 1234.0])
def test_forecast_update_matches_jax(t):
    rng = np.random.default_rng(int(t))
    r, s, f = 4, 8, tfc.NUM_FEATURES
    xs = rng.standard_normal((r, s, 6, f)).astype(np.float32)
    A = np.einsum("rski,rskj->rsij", xs, xs).astype(np.float32)
    b = rng.standard_normal((r, s, f)).astype(np.float32) * 100
    err = rng.uniform(0, 0.5, (r, s)).astype(np.float32)
    count = rng.integers(0, 3, (r, s)).astype(np.int32)
    y = rng.uniform(0, 500, (r, s)).astype(np.float32)
    active = rng.uniform(size=(r, s)) < 0.7
    cfg = tfc.ForecastConfig()
    scal = (cfg.decay, cfg.ridge, cfg.err_alpha, cfg.qps_floor)
    want = jfc._forecast_update(A, b, err, count, jnp.float32(t), y, active,
                                *scal)
    got = tfc._forecast_update(
        *(torch.as_tensor(a) for a in (A, b, err, count)),
        torch.tensor(t, dtype=torch.float32), torch.as_tensor(y),
        torch.as_tensor(active), *scal)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    for i in (0, 1, 2, 4):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]),
                                   rtol=1e-4, atol=1e-4, err_msg=str(i))


# ------------------------------------------------ the engine against JAX's


@pytest.fixture(scope="module")
def jax_engine():
    """JAX ``batched_rollout`` on the scenario, both tick paths, once."""
    events = jstate.extract_plan(SCENARIO_LOG, 0.0, W, CPW)
    runs = {}
    for fused in (False, True):
        final, outs = jstate.batched_rollout(
            jstate.ClusterState.create(N), jax_profiles(), 0.0,
            _jax_keys(SEEDS, W), events, use_pallas=fused)
        runs[fused] = (jax.tree.map(np.asarray, final),
                       {k: np.asarray(v) for k, v in outs.items()})
    return runs


@pytest.mark.parametrize("fused", [False, True])
def test_batched_rollout_matches_jax(jax_engine, fused):
    """B = 3, N = 3 with JAX's draws: final state and hot flags exact,
    qps / cpu / mem / rt within 1e-5, the fold carry within 1e-5."""
    want_final, want = jax_engine[fused]
    events = tstate.extract_plan(SCENARIO_LOG, 0.0, W, CPW)
    final, got = tstate.batched_rollout(
        tstate.ClusterState.create(N, device=CPU), _port_profiles(), 0.0,
        [jax_noise_stream(s, N) for s in SEEDS], events, use_fused=fused)
    assert got["rt"].shape == want["rt"].shape == (3, W, CPW * 10, N, 8)
    _assert_outs(got, want)
    assert want["hot"].any(), "the scenario should trip the detector"
    assert_state_equal(final["state"], want_final["state"])
    np.testing.assert_array_equal(final["t"].numpy(), want_final["t"])
    np.testing.assert_array_equal(final["fc_count"].numpy(),
                                  want_final["fc_count"])
    for k in ("det_hist", "det_mu", "det_cusum", "fc_A", "fc_b", "fc_err"):
        np.testing.assert_allclose(final[k].numpy(), want_final[k],
                                   err_msg=k, **FLOAT_TOL)


def test_scan_windows_continues_a_jax_fold_carry():
    """Two windows in JAX, then the next two in both packages from JAX's
    carry (state, time and fold moved across with ``convert``)."""
    events = jstate.extract_plan(SCENARIO_LOG, 0.0, W, CPW)
    keys = _jax_keys((5,), W)[0]
    det, fc = jstate.fold_configs()
    fleet = jstate.FleetParams.uniform(N)
    first = {k: jnp.asarray(v[:2]) for k, v in events.items()}
    mid, _ = jstate.scan_windows(jstate.ClusterState.create(N),
                                 jax_profiles(), fleet, jnp.float32(0.0),
                                 keys[:2], first, det, fc,
                                 jstate.init_fold_state(N))
    mid = jax.tree.map(np.asarray, mid)

    def carry():
        return (mid["det_hist"], mid["det_mu"], mid["det_cusum"],
                np.int32(2), mid["fc_A"], mid["fc_b"], mid["fc_err"],
                mid["fc_count"])

    rest = {k: v[2:] for k, v in events.items()}
    want_final, want = jstate.scan_windows(
        jax.tree.map(jnp.asarray, mid["state"]), jax_profiles(), fleet,
        jnp.float32(mid["t"]), keys[2:], rest, det, fc,
        tuple(jnp.asarray(a) for a in carry()))
    noise = jax_noise_stream(5, N)
    for _ in range(2 * CPW):                     # the chunks JAX ran first
        next(noise)
    tdet_cfg, tfc_cfg = tstate.fold_configs()
    got_final, got = tstate.scan_windows(
        state_from_numpy(mid["state"], device=CPU), _port_profiles(),
        state_from_numpy(fleet, device=CPU), float(mid["t"]), noise, rest,
        tdet_cfg, tfc_cfg, fold_from_numpy(carry(), device=CPU))
    np.testing.assert_array_equal(got["hot"].numpy(), np.asarray(want["hot"]))
    for k in ("rt", "qps", "cpu_util", "mem_util"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **FLOAT_TOL)
    assert_state_equal(got_final["state"], want_final["state"])
    assert got_final["t"] == float(want_final["t"])
    assert got_final["det_steps"] == 4
    for k in ("det_mu", "det_cusum", "fc_A", "fc_b"):
        np.testing.assert_allclose(got_final[k].numpy(),
                                   np.asarray(want_final[k]), err_msg=k,
                                   **FLOAT_TOL)


# ------------------------------------------------- the engine's invariants


def _own(seeds=SEEDS, fused=True, state=None, events=None, **kw):
    """The scenario on the port's own generator (``SeedNoise``)."""
    if events is None:
        events = tstate.extract_plan(SCENARIO_LOG, 0.0, W, CPW)
    if state is None:
        state = tstate.ClusterState.create(N, device=CPU)
    return tstate.batched_rollout(
        state, _port_profiles(), 0.0,
        [tstate.SeedNoise(s, N, CPU) for s in seeds], events,
        use_fused=fused, **kw)


@pytest.mark.parametrize("fused", [False, True])
def test_seed_rows_equal_single_seed_runs_bitwise(fused):
    """Folding B seeds into B*N rows changes nothing per seed."""
    final, outs = _own(fused=fused)
    for b, s in enumerate(SEEDS):
        one_final, one = _own(seeds=(s,), fused=fused)
        _assert_outs_equal({k: v[b:b + 1] for k, v in outs.items()}, one)
        for k, v in vars(final["state"]).items():
            torch.testing.assert_close(v[b], getattr(one_final["state"], k)[0],
                                       rtol=0, atol=0)
        torch.testing.assert_close(final["det_cusum"][b],
                                   one_final["det_cusum"][0], rtol=0, atol=0)


def test_fused_and_default_ticks_agree():
    """The two tick paths on the same draws: flags and the telemetry the
    kernel does not touch exact, RT (fed by the kernel's means) 1e-5."""
    _, ref = _own(fused=False)
    _, got = _own(fused=True)
    for k in ("hot", "qps", "cpu_util", "mem_util"):
        torch.testing.assert_close(got[k], ref[k], rtol=0, atol=0, msg=k)
    torch.testing.assert_close(got["rt"], ref["rt"], **FLOAT_TOL)


def test_stacked_state_equals_shared_state():
    st = state_from_numpy(loaded_jax_state(num_nodes=N), device=CPU)
    stacked = tstate.ClusterState(**{
        k: torch.stack([v] * len(SEEDS)) for k, v in vars(st).items()})
    _, ref = _own(state=st)
    _, got = _own(state=stacked)
    _assert_outs_equal(got, ref)
    assert float(ref["rt"].sum()) > 0


def test_bucketed_plan_prefix_is_bitwise():
    """bucket=True pads 3 windows to 4; the real prefix is unchanged."""
    log = [e for e in SCENARIO_LOG if e[1] < 3 * CPW * 10]
    plain = tstate.extract_plan(log, 0.0, 3, CPW)
    padded = tstate.extract_plan(log, 0.0, 3, CPW, bucket=True)
    assert padded["op"].shape[0] == 4
    _, ref = _own(events=plain)
    _, got = _own(events=padded)
    _assert_outs_equal(got, ref, slice(0, 3))


def test_shard_request_gives_the_single_device_result():
    """devices=4 clamps to the one device a CPU state has."""
    _, ref = _own()
    _, got = _own(devices=4)
    _assert_outs_equal(got, ref)


def test_shard_request_across_cards_is_refused(monkeypatch):
    """A request that would shard over several visible cards raises; one
    that clamps to a single card passes."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    card = torch.device("cuda")
    with pytest.raises(NotImplementedError, match="not ported"):
        tstate._check_shards(2, card)
    tstate._check_shards(1, card)
    tstate._check_shards(None, card)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    tstate._check_shards(4, card)


def test_seed_axis_varies():
    final, outs = _own()
    rt = outs["rt"][:, :, :, 0, 0]
    assert not torch.allclose(rt[0], rt[1])
    on = final["state"].on_active
    torch.testing.assert_close(on[0], on[1], rtol=0, atol=0)
    torch.testing.assert_close(on[0], on[2], rtol=0, atol=0)


def test_stacked_state_must_match_the_seed_count():
    st = tstate.ClusterState.create(N, device=CPU)
    stacked = tstate.ClusterState(**{k: torch.stack([v] * 2)
                                     for k, v in vars(st).items()})
    with pytest.raises(ValueError, match="seeds"):
        _own(state=stacked)
