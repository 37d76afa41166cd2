"""The port's RWKV-6 pieces (``repro_torch.kernels.rwkv_wkv``,
``repro_torch.models.rwkv``) against the JAX package on the same
numpy-made inputs: ``wkv_plain`` against JAX's ``wkv_chunked`` (y and the
final state) at the default init's clamped decay and at real RWKV decays,
against the Pallas kernel in interpret mode (``ops.wkv``) and against the
naive recurrence ``ref.wkv_ref`` (real decays only: at the clamped decay
the chunked form leaves the recurrence, in JAX as in the port); JAX's
chunk rule, including the lengths it refuses; the decode step, token
shift, time mix and channel mix against JAX."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.kernels import ops, ref
from repro.models import blocks as jblocks
from repro.models import rwkv as jrwkv
from repro_torch import configs as tconfigs
from repro_torch.kernels import rwkv_wkv as K
from repro_torch.models import blocks as tblocks
from repro_torch.models import rwkv as trwkv

# the default init's decay: w0 = 0.6 clamped at 0.18, exp(-exp(0.18))
CLAMPED_W = float(np.exp(-np.exp(np.float32(0.18))))
# float32 against float32: the same terms summed in another order
TOL = dict(rtol=1e-4, atol=1e-4)


def _inputs(B, T, H, P, seed, regime):
    """r, k, v normal; u normal x 0.1 (as test_wkv_sweep); w either the
    clamped constant or uniform in (0.85, 0.999)."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    shape = (B, T, H * P)
    if regime == "clamped":
        w = np.full(shape, CLAMPED_W, f32)
    else:
        w = rng.uniform(0.85, 0.999, shape).astype(f32)
    return dict(r=rng.standard_normal(shape).astype(f32),
                k=rng.standard_normal(shape).astype(f32),
                v=rng.standard_normal(shape).astype(f32),
                w=w, u=(rng.standard_normal((H, P)) * 0.1).astype(f32))


def _j(d):
    return [jnp.asarray(d[n]) for n in "rkvwu"]


def _t(d):
    return [torch.from_numpy(d[n]) for n in "rkvwu"]


def test_clamped_decay_is_what_the_default_init_gives():
    p = jblocks.init_rwkv_layer(jget_smoke("rwkv6-7b"), None,
                                jax.random.PRNGKey(0))
    assert float(p["w0"][0]) == np.float32(0.6)
    ww = jnp.minimum(p["w0"], 0.18)
    np.testing.assert_allclose(float(jnp.exp(-jnp.exp(ww))[0]), CLAMPED_W,
                               rtol=1e-7)


@pytest.mark.parametrize("regime", ["clamped", "real"])
@pytest.mark.parametrize("B,T,H,P", [(1, 64, 2, 16), (2, 128, 4, 32),
                                     (1, 100, 2, 64), (1, 130, 2, 16)])
def test_plain_matches_jax_wkv_chunked(B, T, H, P, regime):
    """y and the final state against JAX's chunked scan at JAX's chunk
    rule (T 100 is one chunk of 100, T 130 two chunks of 65)."""
    d = _inputs(B, T, H, P, T + P, regime)
    jy, jstate = jrwkv.wkv_chunked(*_j(d), H, chunk=min(64, T))
    y, state = trwkv.wkv_chunked(*_t(d), H, chunk=min(64, T))
    assert y.dtype == state.dtype == torch.float32
    assert tuple(state.shape) == (B, H, P, P)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(state.numpy(), np.asarray(jstate), **TOL)


@pytest.mark.parametrize("B,T,H,P", [(1, 64, 2, 16), (2, 128, 4, 32)])
@pytest.mark.parametrize("chunk", [16, 64])
def test_plain_matches_pallas_interpret(B, T, H, P, chunk):
    """The shapes and chunks of test_kernels.py::test_wkv_sweep."""
    d = _inputs(B, T, H, P, chunk + T, "real")
    jy = ops.wkv(*_j(d), H, chunk=chunk)
    y, _ = K.wkv(*_t(d), H, min(chunk, T))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)


def test_plain_matches_pallas_interpret_at_the_clamped_decay():
    d = _inputs(1, 128, 2, 16, 4, "clamped")
    jy = ops.wkv(*_j(d), 2, chunk=64)
    y, _ = K.wkv(*_t(d), 2, 64)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)


@pytest.mark.parametrize("B,T,H,P,chunk", [(1, 64, 2, 16, 64),
                                           (2, 128, 4, 32, 64),
                                           (1, 100, 2, 16, 100),
                                           (1, 130, 2, 16, 65)])
def test_plain_matches_the_recurrence_at_real_decays(B, T, H, P, chunk):
    """2e-4, the limit of test_wkv_sweep; the state against T steps of the
    decode recurrence."""
    d = _inputs(B, T, H, P, T, "real")
    y, state = K.wkv(*_t(d), H, chunk)
    np.testing.assert_allclose(
        y.numpy(), np.asarray(ref.wkv_ref(*_j(d), H)), rtol=2e-4, atol=2e-4)
    r, k, v, w, u = _t(d)
    s = torch.zeros((B, H, P, P))
    for i in range(T):
        _, s = trwkv.wkv_decode(r[:, i:i + 1], k[:, i:i + 1], v[:, i:i + 1],
                                w[:, i:i + 1], u, s)
    np.testing.assert_allclose(state.numpy(), s.numpy(), rtol=2e-4,
                               atol=2e-4)


def test_clamped_decay_leaves_the_recurrence_as_in_jax():
    """At the clamped decay A_incl falls below the 1e-30 floor at step 57
    of a chunk, so from step 58 on both chunked scans differ from the
    recurrence (values here reach ~65), by the same amount."""
    d = _inputs(1, 64, 2, 64, 64, "clamped")
    y, _ = K.wkv(*_t(d), 2, 64)
    rec = np.asarray(ref.wkv_ref(*_j(d), 2))
    jy, _ = jrwkv.wkv_chunked(*_j(d), 2, chunk=64)
    gap = np.abs(y.numpy() - rec).max(axis=(0, 2))
    assert gap[:58].max() < 1e-3 and gap[58:].min() > 1.0
    np.testing.assert_allclose(np.abs(np.asarray(jy) - rec).max(axis=(0, 2)),
                               gap, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("T", [129, 492, 1002])
def test_lengths_jax_refuses_raise(T):
    d = _inputs(1, T, 1, 4, 0, "real")
    with pytest.raises(AssertionError):
        jrwkv.wkv_chunked(*_j(d), 1, chunk=64)
    with pytest.raises(ValueError):
        trwkv.wkv_chunked(*_t(d), 1, chunk=64)


@pytest.mark.parametrize("T,Lc", [(1, 1), (63, 63), (64, 64), (127, 127),
                                  (128, 64), (910, 65), (1024, 64)])
def test_chunk_rule_is_jax_s(T, Lc, monkeypatch):
    seen = []
    monkeypatch.setattr(K, "wkv_plain", lambda *a: seen.append(a[-1]))
    d = _inputs(1, T, 1, 2, 0, "real")
    trwkv.wkv_chunked(*_t(d), 1, chunk=64, use_kernel=False)
    assert seen == [Lc]


def test_wkv_decode_matches_jax():
    d = _inputs(2, 1, 3, 16, 9, "real")
    s0 = np.random.default_rng(1).standard_normal((2, 3, 16, 16)).astype(
        np.float32)
    jy, js = jrwkv.wkv_decode(*_j(d), jnp.asarray(s0))
    y, s = trwkv.wkv_decode(*_t(d), torch.from_numpy(s0))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-5,
                               atol=1e-5)


def _layer_pair(dtype):
    """One smoke rwkv layer's JAX parameters and the port's layer holding
    them, in float32 or bfloat16."""
    jd, td = {"float32": (jnp.float32, torch.float32),
              "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jcfg = dataclasses.replace(jget_smoke("rwkv6-7b"), dtype=jd)
    tcfg = dataclasses.replace(tconfigs.get_smoke_config("rwkv6-7b"),
                               dtype=td)
    p = jblocks.init_rwkv_layer(jcfg, jcfg.pattern[0], jax.random.PRNGKey(3))
    # a live LoRA and mixes, so that the decay varies per token and channel
    rng = np.random.default_rng(3)
    for n in ("wB", "mu_r", "mu_k", "mu_w", "mu_ck"):
        p[n] = jnp.asarray(rng.uniform(0.0, 1.0, p[n].shape) *
                           (0.5 if n == "wB" else 1.0), jnp.float32)
    layer = tblocks.RwkvLayer(tcfg, tcfg.pattern[0], "cpu")
    for name, t in layer.named_parameters():
        t.data.copy_(torch.from_numpy(np.array(p[name], np.float32)))
    x = rng.standard_normal((2, 16, tcfg.d_model)).astype(np.float32)
    xs = rng.standard_normal((2, 16, tcfg.d_model)).astype(np.float32)
    return p, layer, jnp.asarray(x).astype(jd), jnp.asarray(xs).astype(jd), \
        torch.from_numpy(x).to(td), torch.from_numpy(xs).to(td)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_time_mix_matches_jax(dtype):
    """r, k, v, g, w come out float32 in both (JAX promotes the bf16 mix
    with the float32 mu), and agree to float32 rounding."""
    p, layer, jx, jxs, tx, txs = _layer_pair(dtype)
    jout = jrwkv.time_mix_params_apply(jx, jxs, p)
    tout = trwkv.time_mix_params_apply(tx, txs, layer)
    for name, a, b in zip("rkvgw", tout, jout):
        assert a.dtype == torch.float32 and b.dtype == jnp.float32, name
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-4, atol=1e-4,
                                   err_msg=name)
    assert float(tout[4].min()) >= CLAMPED_W * (1 - 1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_channel_mix_matches_jax(dtype):
    p, layer, jx, jxs, tx, txs = _layer_pair(dtype)
    jy = jrwkv.channel_mix(jx, jxs, p)
    ty = trwkv.channel_mix(tx, txs, layer)
    assert ty.dtype == tx.dtype
    # bf16: kk and vv round to bf16 where JAX's code casts
    tol = TOL if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(_np(ty), _np(jy), **tol)


@pytest.mark.parametrize("prev", [False, True])
def test_token_shift_matches_jax(prev):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 7, 8)).astype(np.float32)
    p = rng.standard_normal((2, 1, 8)).astype(np.float32)
    jy = jrwkv.token_shift(jnp.asarray(x), jnp.asarray(p) if prev else None)
    ty = trwkv.token_shift(torch.from_numpy(x),
                           torch.from_numpy(p) if prev else None)
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))


@pytest.mark.parametrize("bad", ["shape", "u", "chunk", "device_mix"])
def test_wrapper_rejects_bad_inputs(bad):
    r, k, v, w, u = _t(_inputs(1, 8, 2, 4, 0, "real"))
    chunk = 8
    if bad == "shape":
        k = k[:, :4]
    elif bad == "u":
        u = u[:1]
    elif bad == "chunk":
        chunk = 3
    else:
        u = u.to("meta")
    with pytest.raises(ValueError):
        K.wkv(r, k, v, w, u, 2, chunk)


def test_cpu_takes_plain_and_counts_no_launch():
    before = K.launches
    K.wkv(*_t(_inputs(1, 8, 2, 4, 0, "real")), 2, 8)
    assert K.launches == before
