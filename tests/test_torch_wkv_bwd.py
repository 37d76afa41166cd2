"""The WKV scan's hand-written backward (``repro_torch.kernels.rwkv_wkv``:
``wkv_bwd_plain``, ``wkv_bwd``, ``WKVScan``) against the JAX package's
autodiff of ``repro.models.rwkv.wkv_chunked`` on the same numpy-made
inputs, against a float64 run of itself, against ``gradcheck``, and wired
through the rwkv6 smoke model.

Tolerances: every gradient within 1e-4 of its largest magnitude (float32
sums of the same terms in another order).  At T 64 and the default
init's decay JAX's 1e-30 floor on A_incl binds, and its autodiff of
``k / max(A_incl, 1e-30)`` (-k / A_incl^2) overflows to NaN: there only
JAX's finite elements are compared, and every element against float64.
An element whose A_incl lies within a float32 rounding of the floor can
sit on opposite sides of it in float32 and float64, which flips the
floor's derivative in its column of dw; such columns are counted in the
message and left out of dw's comparison with float64 only.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import rwkv as jrwkv
from repro_torch import configs as tconfigs
from repro_torch.kernels import rwkv_wkv as K
from repro_torch.models import model as TM
from repro_torch.models import rwkv as trwkv

TOL = 1e-4
NAMES = ("dr", "dk", "dv", "dw", "du")
# the default init's decay: w0 = 0.6 clamped at 0.18, exp(-exp(0.18))
CLAMPED_W = float(np.exp(-np.exp(np.float32(0.18))))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the module's tests: the suite runs in
    several worker processes, and torch's default of one thread a core in
    each makes their small CPU kernels spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(B, T, H, P, seed, regime):
    """r, k, v, dy normal; u normal x 0.1; w the clamped constant or
    uniform in (0.85, 0.999); a final-state gradient."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    shape = (B, T, H * P)
    w = (np.full(shape, CLAMPED_W, f32) if regime == "clamped"
         else rng.uniform(0.85, 0.999, shape).astype(f32))
    return dict(r=rng.standard_normal(shape).astype(f32),
                k=rng.standard_normal(shape).astype(f32),
                v=rng.standard_normal(shape).astype(f32), w=w,
                u=(rng.standard_normal((H, P)) * 0.1).astype(f32),
                dy=rng.standard_normal(shape).astype(f32),
                dstate=rng.standard_normal((B, H, P, P)).astype(f32))


def _jax_vjp(d, H, with_state):
    args = [jnp.asarray(d[n]) for n in "rkvwu"]
    _, vjp = jax.vjp(lambda *a: jrwkv.wkv_chunked(*a, H), *args)
    ds = (jnp.asarray(d["dstate"]) if with_state
          else jnp.zeros(d["dstate"].shape, jnp.float32))
    return [np.asarray(g) for g in vjp((jnp.asarray(d["dy"]), ds))]


def _port(d, H, with_state, dtype=torch.float32):
    t = {n: torch.from_numpy(v).to(dtype) for n, v in d.items()}
    Lc = trwkv.chunk_len(d["r"].shape[1])
    return [g.double().numpy() for g in K.wkv_bwd(
        t["r"], t["k"], t["v"], t["w"], t["u"], H, Lc, t["dy"],
        t["dstate"] if with_state else None)]


def _rel(got, want, where=None) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if where is not None:
        got, want = got[where], want[where]
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _floor_flips(w, H):
    """(B, T, H*P) mask of the chunk columns (b, chunk, h, p) holding an
    A_incl on one side of the 1e-30 floor in float32 and on the other in
    float64, and the number of such elements."""
    B, T, HP = w.shape
    Lc = trwkv.chunk_len(T)
    P = HP // H
    sides = []
    for dtype in (torch.float32, torch.float64):
        x = torch.from_numpy(w).to(dtype).reshape(B, T // Lc, Lc, H, P)
        cum = torch.cumsum(torch.log(torch.clamp_min(x, K.W_FLOOR)), 2)
        sides.append(torch.exp(cum) > K.A_FLOOR)
    flip = sides[0] != sides[1]
    cols = flip.any(2, keepdim=True).expand_as(flip)
    return cols.reshape(B, T, HP).numpy(), int(flip.sum())


def _check(d, H, with_state, expect_nan):
    want = _jax_vjp(d, H, with_state)
    got = _port(d, H, with_state)
    f64 = _port(d, H, with_state, torch.float64)
    assert any(np.isnan(w).any() for w in want) == expect_nan
    cols, flips = _floor_flips(d["w"], H)
    for name, g, w, e in zip(NAMES, got, want, f64):
        assert g.shape == w.shape, name
        assert np.isfinite(g).all(), name
        finite = np.isfinite(w)
        if finite.any():
            assert _rel(g, w, finite) <= TOL, (name, _rel(g, w, finite))
        keep = ~cols if name == "dw" else None
        assert _rel(g, e, keep) <= TOL, (name, _rel(g, e, keep),
                                         f"{flips} elements by the floor")


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("T", [16, 32])
def test_bwd_plain_matches_jax_vjp_at_the_default_decay(T, with_state):
    _check(_inputs(2, T, 3, 16, T + with_state, "clamped"), 3, with_state,
           expect_nan=False)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("T,H,P", [(64, 2, 16), (192, 3, 8), (128, 2, 64)])
def test_bwd_plain_matches_jax_vjp_at_real_decays(T, H, P, with_state):
    """Decays in (0.85, 0.999): no floor binds, JAX is finite."""
    _check(_inputs(2, T, H, P, T + P + with_state, "real"), H, with_state,
           expect_nan=False)


@pytest.mark.parametrize("with_state", [False, True])
def test_bwd_plain_where_the_floors_bind(with_state):
    """T 64 at the default decay: the floor binds from step 57 and JAX's
    gradient holds NaN; the port's is finite, equals JAX's finite elements
    and float64 everywhere."""
    _check(_inputs(2, 64, 2, 16, 7 + with_state, "clamped"), 2, with_state,
           expect_nan=True)


def test_bwd_plain_with_decays_near_the_floor():
    """Random decays in (0.3, 0.35) at T 64: the floor binds at varying
    steps; the port equals float64 (dw's columns that straddle the floor
    between the two types left out and counted) and JAX's finite
    elements."""
    d = _inputs(2, 64, 2, 16, 11, "clamped")
    d["w"] = np.random.default_rng(12).uniform(0.3, 0.35, d["w"].shape
                                               ).astype(np.float32)
    _check(d, 2, True, expect_nan=True)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("T", [100, 127, 160])
def test_bwd_plain_matches_jax_vjp_at_long_chunks(T, with_state):
    """Chunks of more than 64 steps, as JAX's rule gives them: T 100 and
    127 one chunk, T 160 two of 80; real decays, JAX finite."""
    _check(_inputs(2, T, 2, 16, T + with_state, "real"), 2, with_state,
           expect_nan=False)


def _float64_autograd(d, H, with_state):
    """The gradients of autograd through ``wkv_plain`` in float64 (JAX's
    chunk rule), for dy and, with_state, the final state's gradient."""
    leaves = [torch.from_numpy(d[n]).double().requires_grad_()
              for n in "rkvwu"]
    y, s = K.wkv_plain(*leaves, H, trwkv.chunk_len(d["r"].shape[1]))
    loss = (y * torch.from_numpy(d["dy"]).double()).sum()
    if with_state:
        loss = loss + (s * torch.from_numpy(d["dstate"]).double()).sum()
    return [g.numpy() for g in torch.autograd.grad(loss, leaves)]


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("T", [100, 127, 160])
def test_bwd_plain_at_long_chunks_where_jax_is_nan(T, with_state):
    """The default decay at chunks of 100, 127 and 80 steps: the 1e-30
    floor binds from step 57 (and A_excl leaves float32's normal range past
    step ~64), JAX's gradient holds NaN; the port's float32 gradients
    equal JAX's finite elements, the float64 run of itself and autograd
    through the float64 plain forward (which divides by A_incl squared,
    finite in float64); dw's columns that straddle the floor between the
    two types are left out of the float64 comparisons and counted."""
    d = _inputs(2, T, 2, 16, 3 * T + with_state, "clamped")
    _check(d, 2, with_state, expect_nan=True)
    got = _port(d, 2, with_state)
    cols, flips = _floor_flips(d["w"], 2)
    for name, g, a in zip(NAMES, got, _float64_autograd(d, 2, with_state)):
        assert np.isfinite(a).all(), name
        keep = ~cols if name == "dw" else None
        assert _rel(g, a, keep) <= TOL, (name, _rel(g, a, keep),
                                         f"{flips} elements by the floor")


@pytest.mark.parametrize("T", [100, 160])
def test_wkv_chunked_trains_on_the_cpu_at_long_chunks(T):
    """Autograd through ``wkv_chunked`` on the CPU (the plain version, as
    JAX differentiates its ``wkv_chunked``) at T 100 (one chunk of 100)
    and T 160 (two of 80): finite, equal to ``wkv_bwd`` and to JAX's
    ``jax.vjp``."""
    d = _inputs(1, T, 2, 16, T, "real")
    leaves = [torch.from_numpy(d[n]).requires_grad_() for n in "rkvwu"]
    y, s = trwkv.wkv_chunked(*leaves, 2)
    ((y * torch.from_numpy(d["dy"])).sum()
     + (s * torch.from_numpy(d["dstate"])).sum()).backward()
    got = [t.grad.numpy() for t in leaves]
    for name, g, b, j in zip(NAMES, got, _port(d, 2, True),
                             _jax_vjp(d, 2, True)):
        assert np.isfinite(g).all(), name
        assert _rel(g, b) <= TOL, (name, _rel(g, b))
        assert _rel(g, j) <= TOL, (name, _rel(g, j))


@pytest.mark.parametrize("T,Lc", [(8, 8), (12, 4)])
def test_wkv_scan_gradcheck(T, Lc):
    """``WKVScan`` in float64 on the CPU (plain forward, plain backward)
    against finite differences of both outputs, one chunk and three."""
    g = torch.Generator().manual_seed(T)
    d = torch.float64
    H, P = 2, 3
    r, k, v = (torch.randn((1, T, H * P), generator=g, dtype=d)
               for _ in range(3))
    w = torch.rand((1, T, H * P), generator=g, dtype=d) * 0.6 + 0.3
    u = torch.randn((H, P), generator=g, dtype=d) * 0.5
    args = [a.requires_grad_() for a in (r, k, v, w, u)]
    assert torch.autograd.gradcheck(
        lambda *a: K.WKVScan.apply(*a, H, Lc), args)


def test_wkv_bwd_checks_its_arguments():
    d = {n: torch.from_numpy(v)
         for n, v in _inputs(1, 8, 2, 4, 0, "real").items()}
    args = [d[n] for n in "rkvwu"] + [2, 8]
    with pytest.raises(ValueError, match="dy"):
        K.wkv_bwd(*args, d["dy"][:, :4])
    with pytest.raises(ValueError, match="dstate"):
        K.wkv_bwd(*args, d["dy"], d["dstate"][:, :1])


def _train_grads(model, batch, scans):
    params = list(model.parameters())
    orig = trwkv.K
    trwkv.K = scans
    try:
        loss, _ = TM.train_loss(model, batch, remat=True)
        return float(loss.detach()), torch.autograd.grad(loss, params)
    finally:
        trwkv.K = orig


def _float64_plain(r, k, v, w, u, H, Lc):
    """Autograd through ``wkv_plain`` in float64, cast back at its ends."""
    y, s = K.wkv_plain(r.double(), k.double(), v.double(), w.double(),
                       u.double(), H, Lc)
    return y.float(), s.float()


def test_rwkv6_smoke_grads_through_wkv_scan_equal_float64_autograd():
    """The rwkv6 smoke model (float32, T 64 at the init's decay, where the
    floors bind; remat) with its scans through ``WKVScan`` (the plain
    directions on the CPU, selected by swapping the model's kernel module,
    as ``chip_smoke.py`` swaps the Function): every leaf within 1e-4 of its
    largest value of autograd through the plain scan in float64, and
    finite."""
    cfg = dataclasses.replace(tconfigs.get_smoke_config("rwkv6-7b"),
                              dtype=torch.float32)
    model = TM.Model(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(0))
    model.requires_grad_(True)
    rng = np.random.default_rng(2)
    batch = {n: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 64)))
             for n in ("tokens", "labels")}
    calls = []

    class Counted(K.WKVScan):
        @staticmethod
        def backward(ctx, dy, dstate):
            calls.append(dstate is None)
            return K.WKVScan.backward(ctx, dy, dstate)

    through = types.SimpleNamespace(wkv=Counted.apply, wkv_plain=K.wkv_plain)
    loss_f, g_fn = _train_grads(model, batch, through)
    loss_r, g_ref = _train_grads(model, batch, types.SimpleNamespace(
        wkv=_float64_plain, wkv_plain=K.wkv_plain))
    assert calls == [True] * cfg.num_layers       # TRAIN drops the state
    assert loss_f == pytest.approx(loss_r, rel=1e-5)
    for (name, _), a, b in zip(model.named_parameters(), g_fn, g_ref):
        assert torch.isfinite(b).all(), name
        assert torch.isfinite(a).all(), name
        assert _rel(a, b) <= TOL, (name, _rel(a, b))
