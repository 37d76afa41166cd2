"""The port's fused rollout tick (``repro_torch.kernels.rollout_tick``)
against ``repro.kernels.rollout_tick``: the plain version against the
Pallas kernel in interpret mode and its jnp reference, on the same
numpy-made inputs, plus the wrapper's routing and input checks."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rollout_tick import fused_tick as jax_fused_tick
from repro.kernels.rollout_tick import fused_tick_reference
from repro_torch.kernels import rollout_tick as K
from test_torch_noise import assert_hist_close

SLOTS, K_SAMPLES = 14, 16
TOL = dict(rtol=1e-6, atol=0)


def _inputs(rows: int, seed: int) -> dict:
    """Packed inputs as ``_tick_pallas`` builds them, drawn with numpy:
    pressures across the knee, heterogeneous delay curves, some nodes
    oversubscribed, ~60% of slots active, uniforms in [tiny, 1)."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    nodev = np.stack([
        rng.uniform(0.05, 1.3, rows),          # rho_p
        rng.uniform(2.0, 60.0, rows),          # threads_total
        rng.choice([16.0, 32.0, 96.0], rows),  # cores
        rng.uniform(2.0, 4.0, rows),           # delay_base
        rng.uniform(40.0, 70.0, rows),         # delay_scale
        rng.choice([0.03, 0.05, 0.08], rows),  # rho_knee
        rng.uniform(0.1, 0.2, rows),           # oversub_slope
        rng.standard_normal(rows),             # delay noise
    ], axis=-1).astype(f32)
    tiny = np.finfo(f32).tiny
    u = rng.uniform(0.0, 1.0, (2, rows, SLOTS * K_SAMPLES)).astype(f32)
    return dict(
        nodev=nodev,
        jit_all=(1.0 + 0.18 * rng.standard_normal((rows, SLOTS))).astype(f32),
        act_all=(rng.uniform(size=(rows, SLOTS)) < 0.6).astype(f32),
        u1=np.maximum(u[0], tiny), u2=np.maximum(u[1], tiny))


def _port(inp: dict):
    return K.fused_tick(*(torch.as_tensor(inp[k]) for k in
                          ("nodev", "jit_all", "act_all", "u1", "u2")))


def _jax_args(inp: dict):
    return [jnp.asarray(inp[k]) for k in
            ("nodev", "jit_all", "act_all", "u1", "u2")]


@pytest.mark.parametrize("rows,block", [(5, 4), (40, 8)])
def test_plain_matches_pallas_kernel_and_reference(rows, block):
    """R = 5 on block 4 takes the JAX kernel's padding path.  Histogram
    totals are exact; a sample may change bin only where XLA's and torch's
    log differ in the last ulp at a 5-unit edge; delay and mean 1e-6."""
    inp = _inputs(rows, seed=rows)
    hist, delay, mean = _port(inp)
    assert hist.shape == (rows, 200) and delay.shape == (rows,)
    assert mean.shape == (rows, SLOTS)
    np.testing.assert_array_equal(hist.sum(-1).numpy(),
                                  inp["act_all"].sum(-1) * K_SAMPLES)
    for want in (jax_fused_tick(*_jax_args(inp), block=block, interpret=True),
                 fused_tick_reference(*_jax_args(inp))):
        assert_hist_close(hist, want[0])
        np.testing.assert_allclose(delay.numpy(), np.asarray(want[1]), **TOL)
        np.testing.assert_allclose(mean.numpy(), np.asarray(want[2]), **TOL)


def test_pressure_past_the_knee_clips_the_delay():
    inp = _inputs(6, seed=1)
    inp["nodev"][:, 0] = 0.999                 # rho at the knee
    inp["nodev"][:, 7] = 3.0                   # +3 sigma jitter
    _, delay, _ = _port(inp)
    assert float(delay.max()) == pytest.approx(K.CLIP_MAX)


def test_cpu_tensor_takes_the_plain_version(monkeypatch):
    inp = _inputs(7, seed=2)
    calls = []

    def plain(*a, **kw):
        calls.append(a[0].shape)
        return K_plain(*a, **kw)

    K_plain = K.fused_tick_plain
    monkeypatch.setattr(K, "fused_tick_plain", plain)
    before = K.launches
    _port(inp)
    assert calls == [(7, 8)]
    assert K.launches == before


@pytest.mark.parametrize("bad", [
    "nodev_width", "act_shape", "u_ragged", "u_mismatch", "dtype",
    "not_contiguous", "one_dim",
])
def test_bad_inputs_raise(bad):
    t = {k: torch.as_tensor(v) for k, v in _inputs(4, seed=3).items()}
    if bad == "nodev_width":
        t["nodev"] = t["nodev"][:, :7].contiguous()
    elif bad == "act_shape":
        t["act_all"] = t["act_all"][:3]
    elif bad == "u_ragged":
        t["u1"] = t["u1"][:, :-1].contiguous()
        t["u2"] = t["u2"][:, :-1].contiguous()
    elif bad == "u_mismatch":
        t["u2"] = t["u2"][:, :SLOTS * 8].contiguous()
    elif bad == "dtype":
        t["jit_all"] = t["jit_all"].double()
    elif bad == "not_contiguous":
        t["u1"] = t["u1"].t().contiguous().t()
    elif bad == "one_dim":
        t["nodev"] = t["nodev"].reshape(-1)
    with pytest.raises(ValueError):
        K.fused_tick(t["nodev"], t["jit_all"], t["act_all"], t["u1"], t["u2"])
