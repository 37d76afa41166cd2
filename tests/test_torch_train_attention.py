"""The backward of the port's flash attention against the JAX package:
``flash_attention_bwd_plain`` (the CPU side of the backward kernels
``csrc/flash_attention_bwd_sm90.cu`` and ``_f32_sm90.cu``) against JAX's
``_flash_bwd`` called with ``_flash_fwd``'s residuals and against
``jax.vjp`` of ``flash_mha``; the forward's log-sum-exp against those
residuals; the sliding-window route's gradient against ``jax.vjp`` of
JAX's ``attention``; ``FlashAttention.apply`` (lse saved and passed to the
backward) on the CPU against ``jax.vjp`` and against autograd over the
plain forward; and the backward wrapper's checks.  float32 at rtol 1e-5
(the same sums in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro_torch.kernels import flash_attention as FA
from repro_torch.models import attention as tattn


@pytest.fixture(autouse=True)
def _two_threads():
    """Two intra-op threads a test: the suite runs in several worker
    processes, and torch's default of one thread a core in each makes the
    small CPU kernels of a train step spin against each other (a 20-step
    run took 40 times as long under six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ----------------------------------------------------- attention backward --

def _qkv_do(B, S, H, KV, hd, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, S, h, hd)).astype(np.float32)
            for h in (H, KV, KV, H)]


@pytest.mark.parametrize("S,kv_block", [(64, 32), (50, 64)])
@pytest.mark.parametrize("hd", [16, 64])
@pytest.mark.parametrize("G", [1, 2, 3])
@pytest.mark.parametrize("causal", [True, False])
def test_bwd_plain_matches_jax_flash_bwd(causal, G, hd, S, kv_block):
    """``flash_attention_bwd_plain`` against JAX's ``_flash_bwd`` on the
    residuals of ``_flash_fwd`` (S a multiple of the KV block, and a
    ragged S in one block), dk and dv summed over each KV head's G query
    heads as ``_repeat_kv``'s gradient does; and against ``jax.vjp`` of
    ``flash_mha``."""
    KV = 2
    H = KV * G
    q, k, v, do = _qkv_do(2, S, H, KV, hd, seed=S + hd + G)
    kr = jnp.repeat(jnp.asarray(k), G, axis=2)
    vr = jnp.repeat(jnp.asarray(v), G, axis=2)
    n_chunks = jattn.N_Q_CHUNKS
    out, res = jattn._flash_fwd(jnp.asarray(q), kr, vr, causal, kv_block,
                                n_chunks)
    jdq, jdk, jdv = jattn._flash_bwd(causal, kv_block, n_chunks, res,
                                     jnp.asarray(do))
    fold = lambda x: np.asarray(x).reshape(2, S, KV, G, hd).sum(3)  # noqa
    t = [torch.from_numpy(a) for a in (q, k, v, do)]
    tout = torch.from_numpy(np.array(out))
    dq, dk, dv = FA.flash_attention_bwd_plain(t[0], t[1], t[2], tout, t[3],
                                              causal=causal)
    np.testing.assert_allclose(dq.numpy(), np.asarray(jdq), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(dk.numpy(), fold(jdk), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dv.numpy(), fold(jdv), rtol=1e-5, atol=1e-5)
    _, vjp = jax.vjp(lambda a, b, c: jattn.flash_mha(a, b, c, causal,
                                                     kv_block, n_chunks),
                     jnp.asarray(q), kr, vr)
    for got, want in zip((dq, dk, dv), vjp(jnp.asarray(do))):
        want = np.asarray(want)
        if want.shape != tuple(got.shape):
            want = fold(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("window", [16, 40])
def test_windowed_gradient_matches_jax(window):
    """The sliding-window route under autograd (``FlashAttention`` with
    the window; on the CPU the backward's plain formulas) against
    ``jax.vjp`` of JAX's ``attention(..., sliding_window=w)``, which
    differentiates ``_sliding_window``."""
    q, k, v, do = _qkv_do(2, 96, 4, 2, 16, seed=window)
    _, vjp = jax.vjp(lambda a, b, c: jattn.attention(
        a, b, c, causal=True, sliding_window=window, q_block=32,
        kv_block=32), *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = tattn.attention(tq, tk, tv, causal=True, sliding_window=window)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0),
                                           (True, 10), (False, 10)])
def test_flash_autograd_function_on_cpu_equals_plain_autograd(causal,
                                                              window):
    """``FlashAttention.apply`` (forward wrapper, backward formulas) gives
    autograd-over-``flash_attention_plain``'s gradients, and counts no
    kernel launch on the CPU."""
    q, k, v, do = (torch.from_numpy(x) for x in _qkv_do(2, 70, 6, 2, 16, 3))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    before = (FA.launches, FA.bwd_launches)
    got = torch.autograd.grad(
        FA.FlashAttention.apply(*leaves, causal, window), leaves, do)
    assert (FA.launches, FA.bwd_launches) == before
    want = torch.autograd.grad(FA.flash_attention_plain(
        *leaves, causal=causal, sliding_window=window), leaves, do)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


def test_bwd_wrapper_rejects_mismatched_out():
    q, k, v, do = (torch.from_numpy(x) for x in _qkv_do(1, 16, 2, 2, 16, 0))
    lse = torch.zeros((1, 2, 16))
    with pytest.raises(ValueError, match="out"):
        FA.flash_attention_bwd(q, k, v, q[:, :8], do, lse)
    with pytest.raises(ValueError, match="dout"):
        FA.flash_attention_bwd(q, k, v, q, do.double(), lse)
    for bad in (lse[:, :, :8], lse.double(), lse.transpose(1, 2)):
        with pytest.raises(ValueError, match="lse"):
            FA.flash_attention_bwd(q, k, v, q, do, bad)


@pytest.mark.parametrize("S,kv_block", [(64, 32), (50, 64)])
@pytest.mark.parametrize("hd", [16, 64])
@pytest.mark.parametrize("G", [1, 2, 3])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_lse_matches_jax_residuals(causal, G, hd, S, kv_block):
    """The forward's log-sum-exp (``flash_attention_plain(...,
    return_lse=True)``, the CPU side of what the forward kernels write for
    the backward) against JAX's ``_flash_fwd_impl`` residuals as ``m +
    log(max(l, 1e-30))``, on the cases of the JAX-parity test above;
    float32 at 1e-5 (logs of the same sums in another order)."""
    KV = 2
    H = KV * G
    q, k, v, _ = _qkv_do(2, S, H, KV, hd, seed=S + hd + G)
    kr = jnp.repeat(jnp.asarray(k), G, axis=2)
    vr = jnp.repeat(jnp.asarray(v), G, axis=2)
    _, m, l = jattn._flash_fwd_impl(jnp.asarray(q), kr, vr, causal,
                                    kv_block, jattn.N_Q_CHUNKS)
    want = np.asarray(m + jnp.log(jnp.maximum(l, 1e-30)))
    out, lse = FA.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                  causal=causal, return_lse=True)
    assert lse.shape == (2, H, S) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("window", [0, 24])
@pytest.mark.parametrize("G", [1, 3])
def test_autograd_function_with_lse_matches_jax_vjp(G, window):
    """``FlashAttention`` on the CPU, its forward saving the lse and its
    backward taking it (through ``flash_attention_bwd``), against
    ``jax.vjp`` of ``flash_mha`` (without a window) or of JAX's
    ``attention`` with the window (its ``_sliding_window`` route), dk and
    dv summed over each KV head's G query heads; float32 at 1e-5."""
    KV, S, hd = 2, 64, 16
    H = KV * G
    q, k, v, do = _qkv_do(2, S, H, KV, hd, seed=40 + G + window)
    seen = []
    real = FA.flash_attention_bwd

    def spy(*a, **kw):
        seen.append(a[5])
        return real(*a, **kw)

    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    FA.flash_attention_bwd = spy
    try:
        got = torch.autograd.grad(FA.FlashAttention.apply(
            *leaves, True, window), leaves, torch.from_numpy(do))
    finally:
        FA.flash_attention_bwd = real
    assert len(seen) == 1 and seen[0].shape == (2, H, S)
    if window:
        fn = lambda a, b, c: jattn.attention(  # noqa: E731
            a, b, c, causal=True, sliding_window=window, q_block=32,
            kv_block=32)
        args = (jnp.asarray(x) for x in (q, k, v))
    else:
        fn = lambda a, b, c: jattn.flash_mha(  # noqa: E731
            a, b, c, True, 32, jattn.N_Q_CHUNKS)
        args = (jnp.asarray(q), jnp.repeat(jnp.asarray(k), G, axis=2),
                jnp.repeat(jnp.asarray(v), G, axis=2))
    _, vjp = jax.vjp(fn, *args)
    for g, w in zip(got, vjp(jnp.asarray(do))):
        w = np.asarray(w)
        if w.shape != tuple(g.shape):
            w = w.reshape(2, S, KV, G, hd).sum(3)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5)
