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


def _bf16_inputs(B, T, H, P, N, seed):
    t = _t(_inputs(B, T, H, P, N, seed))
    for k in ("x", "B_", "C"):
        t[k] = t[k].bfloat16()
    return t


class _Lib:
    """A stand-in for ``build.load``'s library: records which library and
    entry a launch reached, and the arguments, and returns ``rc``."""

    def __init__(self, rc=0):
        self.rc, self.calls, self.fns = rc, [], {}

    def load(self, name):
        outer = self

        class Fn:
            argtypes = None

            def __call__(self, *args):
                outer.calls.append((name, self.symbol, args))
                return outer.rc

        class Lib:
            def __getattr__(self, symbol):
                fn = outer.fns.setdefault((name, symbol), Fn())
                fn.symbol = symbol
                return fn
        return Lib()


@pytest.mark.parametrize("dtype,lib,symbol,ints", [
    ("bfloat16", "ssd_sm90", "ssd_sm90_launch", 6),
    ("float32", "ssd", "ssd_launch", 7),
])
def test_launch_routes_by_dtype(monkeypatch, dtype, lib, symbol, ints):
    """bf16 goes to the tensor-core kernel (with a sync buffer, no dtype
    code), float32 to the SIMT one (dtype code 0); one launch, counted
    once, and nothing else is tried."""
    fake = _Lib()
    monkeypatch.setattr(K.build, "load", fake.load)
    monkeypatch.setattr(K.build, "device_and_stream", lambda t: (0, 7))
    t = _bf16_inputs(2, 40, 5, 32, 16, 3) if dtype == "bfloat16" else \
        _t(_inputs(2, 40, 5, 32, 16, 3))
    before = K.launches
    y, state = K._launch(t["x"], t["dt"], t["A"], t["B_"], t["C"])
    assert K.launches == before + 1
    assert y.shape == t["x"].shape and y.dtype == t["x"].dtype
    assert state.shape == (2, 5, 32, 16) and state.dtype == torch.float32
    assert [(n, s) for n, s, _ in fake.calls] == [(lib, symbol)]
    args = fake.calls[0][2]
    ptrs = 8 if dtype == "bfloat16" else 7
    assert len(fake.fns[(lib, symbol)].argtypes) == ptrs + ints + 1
    assert len(args) == ptrs + ints + 1
    assert args[ptrs:ptrs + 5] == (2, 40, 5, 32, 16) and args[-2:] == (0, 7)
    if dtype == "float32":
        assert args[ptrs + 5] == 0


def test_bf16_launch_hands_zeroed_state_and_ticket(monkeypatch):
    """The bf16 kernel passes the state from chunk to chunk through the
    state output and reads a zero as "not yet written"; its ticket and its
    counts of written chunks (one a (batch, group of heads), so at most one
    a (batch, head)) are a second buffer: both zero, allocated for the
    call."""
    seen = []
    real_zeros = torch.zeros

    def zeros(*shape, **kw):
        out = real_zeros(*shape, **kw)
        seen.append(out)
        return out

    fake = _Lib()
    monkeypatch.setattr(K.build, "load", fake.load)
    monkeypatch.setattr(K.build, "device_and_stream", lambda t: (0, 0))
    monkeypatch.setattr(K.torch, "zeros", zeros)
    t = _bf16_inputs(3, 16, 5, 16, 16, 4)
    y, state = K._launch(t["x"], t["dt"], t["A"], t["B_"], t["C"])
    (zstate, sync) = seen
    assert zstate is state and not state.any()
    assert sync.shape == (1 + 3 * 5,)
    assert sync.dtype == torch.int32 and not sync.any()
    args = fake.calls[0][2]
    assert args[6] == state.data_ptr() and args[7] == sync.data_ptr()


@pytest.mark.parametrize("P,N", [(24, 16), (64, 8), (80, 16), (64, 96)])
def test_bf16_launch_refuses_shapes_before_any_launch(monkeypatch, P, N):
    """P or N not a multiple of 16, or past 64: the bf16 kernel does not
    take them, and the wrapper raises before it loads or launches anything
    (there is no fallback to the SIMT kernel)."""
    fake = _Lib()
    monkeypatch.setattr(K.build, "load", fake.load)
    monkeypatch.setattr(K.build, "device_and_stream", lambda t: (0, 0))
    t = _bf16_inputs(1, 8, 2, P, N, 0)
    before = K.launches
    with pytest.raises(ValueError):
        K._launch(t["x"], t["dt"], t["A"], t["B_"], t["C"])
    assert K.launches == before and not fake.calls and not fake.fns


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_launch_raises_on_a_failed_launch(monkeypatch, dtype):
    fake = _Lib(rc=719)
    monkeypatch.setattr(K.build, "load", fake.load)
    monkeypatch.setattr(K.build, "device_and_stream", lambda t: (0, 0))
    t = _bf16_inputs(1, 16, 2, 16, 16, 6) if dtype == "bfloat16" else \
        _t(_inputs(1, 16, 2, 16, 16, 6))
    before = K.launches
    with pytest.raises(RuntimeError, match="719"):
        K._launch(t["x"], t["dt"], t["A"], t["B_"], t["C"])
    assert K.launches == before


def _split(v):
    """float32 v as bf16 hi = bf16(v) and lo = bf16(v - hi), as the bf16
    kernel splits each float32 operand of its products."""
    hi = v.bfloat16()
    return hi, (v - hi.float()).bfloat16()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_operand_keeps_float32_state(seed):
    """One chunk's state contribution x^T (dec o B) at the serve's value
    ranges (dt in (0.01, 0.2), A in [-16, -1], randn x/B), with dec o B
    split as a bf16 hi + lo pair, exact bf16 x and float32 sums, is within
    1e-4 of float64; one bf16 rounding of dec o B is not (the state is held
    to 1e-4), which is why the kernel multiplies by both halves."""
    rng = np.random.default_rng(seed)
    L, P, N = 64, 64, 64
    x = torch.from_numpy(rng.standard_normal((L, P)).astype(np.float32))
    Bm = torch.from_numpy(rng.standard_normal((L, N)).astype(np.float32))
    x, Bm = x.bfloat16(), Bm.bfloat16()          # bf16 inputs, exact below
    dt = rng.uniform(0.01, 0.2, L)
    a = -rng.uniform(1.0, 16.0)
    cum = np.cumsum(dt * a)
    dec = torch.from_numpy((np.exp(cum[-1] - cum) * dt).astype(np.float32))
    decB = dec[:, None] * Bm.float()             # float32, as in the kernel
    want = x.double().T @ (dec.double()[:, None] * Bm.double())
    hi, lo = _split(decB)
    xf = x.float()
    two = xf.T @ hi.float() + xf.T @ lo.float()
    one = xf.T @ hi.float()
    err_two = float((two.double() - want).abs().max())
    err_one = float((one.double() - want).abs().max())
    assert err_two < 1e-4, err_two
    assert err_one > 1e-4, err_one


def test_phase_tool_patches_match_the_kernel_source():
    """``tools/ssd_sm90_phases.py`` builds patched copies of
    ``csrc/ssd_sm90.cu`` (G, timing-only variants); each text it replaces
    must still be in the source (G's line once), or the tool fails on the
    card; and it names each of the kernel's phase marks."""
    import importlib.util
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    spec = importlib.util.spec_from_file_location(
        "ssd_sm90_phases", root / "tools" / "ssd_sm90_phases.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    src = (K.build.CSRC / "ssd_sm90.cu").read_text()
    assert src.count(tool.GROUP_LINE) == 1
    for reps in tool.VARIANTS.values():
        for pattern, _ in reps:
            assert pattern in src, pattern
    assert src.count("MARK(") - src.count("#define MARK(") == len(tool.MARKS)
