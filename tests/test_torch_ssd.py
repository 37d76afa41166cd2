"""The port's SSD scan (``repro_torch.kernels.ssd``, ``repro_torch.models.
ssd``) against the JAX package on the same numpy-made inputs: the plain
version against the Pallas kernel in interpret mode (``ops.ssd``) and the
naive recurrence ``ref.ssd_ref`` (2e-4, as ``test_ssd_sweep``), the final
state against ``models.ssd.ssd_chunked``'s, a ragged T against
``ssd_ref``, and the decode step and causal conv against JAX."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro.models import ssd as jssd
from repro_torch.kernels import ssd as K
from repro_torch.models import ssd as tssd

TOL = dict(rtol=2e-4, atol=2e-4)


def _inputs(B, T, H, P, N, seed):
    """x, B, C normal; dt in [0.01, 0.2]; A in [-2, -0.5] (as the sweep)."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return dict(
        x=rng.standard_normal((B, T, H, P)).astype(f32),
        dt=rng.uniform(0.01, 0.2, (B, T, H)).astype(f32),
        A=-rng.uniform(0.5, 2.0, (H,)).astype(f32),
        B_=rng.standard_normal((B, T, N)).astype(f32),
        C=rng.standard_normal((B, T, N)).astype(f32),
    )


def _j(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _t(d):
    return {k: torch.from_numpy(v) for k, v in d.items()}


@pytest.mark.parametrize("B,T,H,P,N", [(1, 64, 2, 16, 8),
                                       (2, 128, 4, 32, 16),
                                       (1, 192, 2, 64, 64)])
def test_plain_matches_pallas_and_ref(B, T, H, P, N):
    d = _inputs(B, T, H, P, N, T + P)
    y, _ = K.ssd(**_t(d))
    np.testing.assert_allclose(y.numpy(), np.asarray(ops.ssd(**_j(d))), **TOL)
    np.testing.assert_allclose(y.numpy(), np.asarray(ref.ssd_ref(**_j(d))),
                               **TOL)


@pytest.mark.parametrize("T", [16, 64, 128])
def test_final_state_matches_ssd_chunked(T):
    d = _inputs(2, T, 3, 16, 8, T)
    jy, jstate = jssd.ssd_chunked(**_j(d), chunk=min(64, T))
    y, state = tssd.ssd_chunked(**_t(d))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(state.numpy(), np.asarray(jstate), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("T", [1, 37, 100, 1000])
def test_ragged_t_matches_ref(T):
    """Any T (JAX's chunked scan asserts that chunks tile T): y against the
    naive recurrence, and the final state against the state after T steps
    of the decode recurrence."""
    d = _inputs(1, T, 2, 16, 8, T)
    y, state = K.ssd(**_t(d))
    np.testing.assert_allclose(y.numpy(), np.asarray(ref.ssd_ref(**_j(d))),
                               **TOL)
    s = torch.zeros((1, 2, 16, 8))
    t = _t(d)
    for i in range(T):
        _, s = tssd.ssd_decode(t["x"][:, i:i + 1], t["dt"][:, i:i + 1],
                               t["A"], t["B_"][:, i:i + 1],
                               t["C"][:, i:i + 1], s)
    np.testing.assert_allclose(state.numpy(), s.numpy(), **TOL)


def test_bfloat16_inputs_cast_like_jax():
    d = _inputs(1, 64, 2, 16, 8, 5)
    jd = _j(d)
    for k in ("x", "B_", "C"):
        jd[k] = jd[k].astype(jnp.bfloat16)
    td = _t(d)
    for k in ("x", "B_", "C"):
        td[k] = td[k].bfloat16()
    jy, jstate = jssd.ssd_chunked(**jd, chunk=64)
    y, state = tssd.ssd_chunked(**td)
    assert y.dtype == torch.bfloat16 and state.dtype == torch.float32
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(jy.astype(jnp.float32)),
                               rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(state.numpy(), np.asarray(jstate), rtol=1e-4,
                               atol=1e-4)


def test_ssd_decode_matches_jax():
    d = _inputs(2, 1, 3, 16, 8, 9)
    s0 = np.random.default_rng(1).standard_normal((2, 3, 16, 8)).astype(
        np.float32)
    jy, js = jssd.ssd_decode(**_j(d), state=jnp.asarray(s0))
    y, s = tssd.ssd_decode(**_t(d), state=torch.from_numpy(s0))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_prev", [False, True])
def test_causal_conv1d_matches_jax(dtype, with_prev):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 9, 6)).astype(np.float32)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    prev = rng.standard_normal((2, 3, 6)).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jy, jp = jssd.causal_conv1d(
        jnp.asarray(x).astype(jdt), jnp.asarray(w).astype(jdt),
        jnp.asarray(prev).astype(jdt) if with_prev else None)
    y, p = tssd.causal_conv1d(
        torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt),
        torch.from_numpy(prev).to(tdt) if with_prev else None)
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else \
        dict(rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(jy.astype(jnp.float32)), **tol)
    np.testing.assert_allclose(p.float().numpy(),
                               np.asarray(jp.astype(jnp.float32)), **tol)


@pytest.mark.parametrize("with_prev", [False, True])
def test_causal_conv1d_state_owns_its_storage(with_prev):
    """The (B, K-1, C) conv state is a tensor of its own, not a view of the
    padded input: the decode cache keeps it, and a view would keep the
    whole (B, T+K-1, C) input alive with it.  Values equal JAX's exactly."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 33, 6)).astype(np.float32)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    prev = rng.standard_normal((2, 3, 6)).astype(np.float32)
    _, jp = jssd.causal_conv1d(jnp.asarray(x), jnp.asarray(w),
                               jnp.asarray(prev) if with_prev else None)
    _, p = tssd.causal_conv1d(torch.from_numpy(x), torch.from_numpy(w),
                              torch.from_numpy(prev) if with_prev else None)
    assert tuple(p.shape) == (2, 3, 6) and p.is_contiguous()
    assert p._base is None
    assert p.untyped_storage().nbytes() == p.numel() * p.element_size()
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))


@pytest.mark.parametrize("bad", ["shape", "device_mix"])
def test_wrapper_rejects_bad_inputs(bad):
    t = _t(_inputs(1, 8, 2, 16, 8, 0))
    if bad == "shape":
        t["dt"] = t["dt"][:, :4]
    else:
        t["A"] = t["A"].to("meta")
    with pytest.raises(ValueError):
        K.ssd(**t)


def test_cpu_takes_plain_and_counts_no_launch():
    before = K.launches
    K.ssd(**_t(_inputs(1, 8, 2, 16, 8, 0)))
    assert K.launches == before
