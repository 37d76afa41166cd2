"""The SSD scan's hand-written backward (``repro_torch.kernels.ssd``:
``ssd_bwd_plain``, ``ssd_bwd``, ``SSDScan``) against the JAX package's
autodiff of ``repro.models.ssd.ssd_chunked`` on the same numpy-made
inputs, against a float64 run of itself, against ``gradcheck``, and wired
through the zamba2 smoke model.

Tolerances: every gradient within 1e-4 of its largest magnitude (float32
sums of the same terms in another order; the largest term sets the
rounding).  JAX's own gradient is NaN where the decay is fast (its
``ssd_chunked`` takes exp of the positive cum_t - cum_s above the diagonal
before masking it, and the masked gradient is 0 * inf): there only JAX's
finite elements are compared, and every element against float64.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssd as jssd
from repro_torch import configs as tconfigs
from repro_torch.kernels import ssd as K
from repro_torch.models import model as TM
from repro_torch.models import ssd as tssd

TOL = 1e-4
NAMES = ("dx", "ddt", "dA", "dB", "dC")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the module's tests: the suite runs in
    several worker processes, and torch's default of one thread a core in
    each makes their small CPU kernels spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(B, T, H, P, N, seed):
    """x, B, C, dy normal; dt in [0.01, 0.2]; A in [-2, -0.5] (Mamba-2's
    usual ranges, where JAX's gradient is finite); a final-state
    gradient."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return dict(
        x=rng.standard_normal((B, T, H, P)).astype(f32),
        dt=rng.uniform(0.01, 0.2, (B, T, H)).astype(f32),
        A=-rng.uniform(0.5, 2.0, (H,)).astype(f32),
        B_=rng.standard_normal((B, T, N)).astype(f32),
        C=rng.standard_normal((B, T, N)).astype(f32),
        dy=rng.standard_normal((B, T, H, P)).astype(f32),
        dstate=rng.standard_normal((B, H, P, N)).astype(f32))


def _jax_vjp(d, with_state):
    """JAX's (dx, ddt, dA, dB, dC) of ``ssd_chunked`` for dy and dstate."""
    args = [jnp.asarray(d[n]) for n in ("x", "dt", "A", "B_", "C")]
    T = d["x"].shape[1]
    _, vjp = jax.vjp(lambda *a: jssd.ssd_chunked(*a, chunk=min(64, T)),
                     *args)
    ds = (jnp.asarray(d["dstate"]) if with_state
          else jnp.zeros(d["dstate"].shape, jnp.float32))
    return [np.asarray(g) for g in vjp((jnp.asarray(d["dy"]), ds))]


def _port(d, with_state, dtype=torch.float32):
    t = {n: torch.from_numpy(v).to(dtype) for n, v in d.items()}
    return [g.double().numpy() for g in K.ssd_bwd(
        t["x"], t["dt"], t["A"], t["B_"], t["C"], t["dy"],
        t["dstate"] if with_state else None)]


def _rel(got, want, where=None) -> float:
    """max |got - want| over the compared elements, over want's largest
    magnitude there."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if where is not None:
        got, want = got[where], want[where]
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("B,T,H,P,N", [(2, 64, 2, 16, 8),
                                       (2, 192, 3, 32, 16),
                                       (1, 128, 4, 64, 64)])
def test_bwd_plain_matches_jax_vjp(B, T, H, P, N, with_state):
    d = _inputs(B, T, H, P, N, T + P + with_state)
    want = _jax_vjp(d, with_state)
    got = _port(d, with_state)
    f64 = _port(d, with_state, torch.float64)
    for name, g, w, e in zip(NAMES, got, want, f64):
        assert np.isfinite(w).all(), name
        assert g.shape == w.shape, name
        assert _rel(g, w) <= TOL, (name, _rel(g, w))
        assert _rel(g, e) <= TOL, (name, _rel(g, e))


def _smoke_init_inputs(T=64, seed=0):
    """The inputs the zamba2 smoke model's first mamba layer hands its scan
    at the port's init (A = -linspace(1, 16, H), dt = softplus(. - 2)), for
    a random token batch; dy and dstate normal."""
    cfg = tconfigs.get_smoke_config("zamba2-1.2b")
    model = TM.Model(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(seed))
    seen = []

    def record(*args):
        seen.append([a.detach().clone() for a in args])
        return K.ssd(*args)

    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, T)))
    orig = tssd.K
    tssd.K = types.SimpleNamespace(ssd=record, ssd_plain=K.ssd_plain)
    try:
        model(tokens)
    finally:
        tssd.K = orig
    x, dt, A, B_, C = (a.float().numpy() for a in seen[0])
    Bsz, _, H, P = x.shape
    return dict(x=x, dt=dt, A=A, B_=B_, C=C,
                dy=rng.standard_normal(x.shape).astype(np.float32),
                dstate=rng.standard_normal((Bsz, H, P, B_.shape[-1])
                                           ).astype(np.float32))


@pytest.mark.parametrize("with_state", [False, True])
def test_bwd_plain_at_the_zamba2_smoke_init(with_state):
    """Where JAX's gradient holds NaN: the port's is finite everywhere,
    equals JAX's finite elements, and equals float64 everywhere."""
    d = _smoke_init_inputs()
    assert d["A"].min() <= -15.0      # decays fast enough to overflow JAX
    want = _jax_vjp(d, with_state)
    got = _port(d, with_state)
    f64 = _port(d, with_state, torch.float64)
    assert any(np.isnan(w).any() for w in want), "JAX is finite here"
    for name, g, w, e in zip(NAMES, got, want, f64):
        assert np.isfinite(g).all(), name
        finite = np.isfinite(w)
        if finite.any():
            assert _rel(g, w, finite) <= TOL, (name, _rel(g, w, finite))
        assert _rel(g, e) <= TOL, (name, _rel(g, e))


@pytest.mark.parametrize("T", [16, 37, 70])
def test_ssd_scan_gradcheck(T):
    """``SSDScan`` in float64 on the CPU (plain forward, plain backward)
    against finite differences of both outputs, at a ragged T too (the
    port pads it to whole chunks where JAX asserts)."""
    g = torch.Generator().manual_seed(T)
    d = torch.float64
    x = torch.randn((1, T, 2, 3), generator=g, dtype=d)
    dt = torch.rand((1, T, 2), generator=g, dtype=d) * 0.19 + 0.01
    A = -(torch.rand((2,), generator=g, dtype=d) * 1.5 + 0.5)
    B_ = torch.randn((1, T, 2), generator=g, dtype=d)
    C = torch.randn((1, T, 2), generator=g, dtype=d)
    args = [a.requires_grad_() for a in (x, dt, A, B_, C)]
    assert torch.autograd.gradcheck(K.SSDScan.apply, args)


@pytest.mark.parametrize("B,nc,H,sms,heads", [
    (4, 16, 64, 132, 8),   # zamba2-1.2b's train microbatch: 512 blocks
    (4, 4, 8, 132, 1),     # the smoke width: 16 blocks at 8 heads
    (2, 16, 64, 132, 4),   # 256 blocks at 8 heads, under two an SM
    (1, 1, 1, 132, 1),
])
def test_bwd_heads_a_block(B, nc, H, sms, heads):
    """The backward kernel's heads a block: BWD_HEADS, halved while that
    leaves fewer than two blocks for each of the card's multiprocessors."""
    assert K._bwd_heads(B, nc, H, sms) == heads


def test_ssd_bwd_checks_its_arguments():
    d = {n: torch.from_numpy(v) for n, v in _inputs(1, 8, 2, 4, 3, 0).items()}
    args = (d["x"], d["dt"], d["A"], d["B_"], d["C"])
    with pytest.raises(ValueError, match="dy"):
        K.ssd_bwd(*args, d["dy"][:, :4])
    with pytest.raises(ValueError, match="dstate"):
        K.ssd_bwd(*args, d["dy"], d["dstate"][:, :1])
    with pytest.raises(ValueError, match="dy"):
        K.ssd_bwd(*args, d["dy"].double())


def _train_grads(model, batch, scans):
    """Every parameter's gradient of ``train_loss`` (remat on) with the
    model's ``ssd`` calls routed through ``scans``."""
    params = list(model.parameters())
    orig = tssd.K
    tssd.K = scans
    try:
        loss, _ = TM.train_loss(model, batch, remat=True)
        return float(loss.detach()), torch.autograd.grad(loss, params)
    finally:
        tssd.K = orig


def _float64_plain(x, dt, A, B_, C):
    """Autograd through ``ssd_plain`` in float64, cast back at its ends."""
    y, s = K.ssd_plain(x.double(), dt.double(), A.double(), B_.double(),
                       C.double())
    return y.to(x.dtype), s.float()


def test_zamba2_smoke_grads_through_ssd_scan_equal_float64_autograd():
    """The zamba2 smoke model (float32, T 64, remat, the shared block every
    second layer, the D skip and the causal conv) with its scans through
    ``SSDScan`` (the plain directions on the CPU, selected by swapping the
    model's kernel module, as ``chip_smoke.py`` swaps the Function): every
    leaf within 1e-4 of its largest value of autograd through the plain
    scan in float64, and finite, where autograd through the float32 plain
    scan is NaN."""
    cfg = dataclasses.replace(tconfigs.get_smoke_config("zamba2-1.2b"),
                              dtype=torch.float32)
    model = TM.Model(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(0))
    model.requires_grad_(True)
    rng = np.random.default_rng(1)
    batch = {n: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 64)))
             for n in ("tokens", "labels")}
    calls = []

    class Counted(K.SSDScan):
        @staticmethod
        def backward(ctx, dy, dstate):
            calls.append(dstate is None)
            return K.SSDScan.backward(ctx, dy, dstate)

    through = types.SimpleNamespace(ssd=Counted.apply, ssd_plain=K.ssd_plain)
    loss_f, g_fn = _train_grads(model, batch, through)
    loss_r, g_ref = _train_grads(model, batch, types.SimpleNamespace(
        ssd=_float64_plain, ssd_plain=K.ssd_plain))
    _, g_f32 = _train_grads(model, batch, K)
    assert calls == [True] * cfg.num_layers       # TRAIN drops the state
    assert loss_f == pytest.approx(loss_r, rel=1e-5)
    assert any(not torch.isfinite(g).all() for g in g_f32)
    for (name, _), a, b in zip(model.named_parameters(), g_fn, g_ref):
        assert torch.isfinite(b).all(), name
        assert torch.isfinite(a).all(), name
        assert _rel(a, b) <= TOL, (name, _rel(a, b))
