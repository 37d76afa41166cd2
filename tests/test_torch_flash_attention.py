"""The port's flash attention (``repro_torch.kernels.flash_attention``)
against the JAX package: its plain version against ``ref.
flash_attention_ref`` and the model's ``repro.models.attention.attention``
on the same numpy-made inputs, plus the wrapper's routing and checks.

Tolerances: float32 2e-5 and bfloat16 2e-2, as ``tests/test_kernels.py``
holds the Pallas kernel to the same reference.  (The Pallas kernel itself
cannot run on the installed JAX, so it is not an oracle here.)
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.models import attention as jattn
from repro_torch.kernels import flash_attention as FA
from repro_torch.models import attention as tattn

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _qkv(B, S, H, KV, hd, seed, dtype="float32"):
    """numpy float32 draws, rounded to ``dtype`` identically on both sides."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((B, S, h, hd)).astype(np.float32)
            for h in (H, KV, KV)]
    jx = [jnp.asarray(a).astype(JNP[dtype]) for a in arrs]
    tx = [torch.from_numpy(a).to(TORCH[dtype]) for a in arrs]
    return jx, tx


def _f32(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else
                      jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,H,hd", [(1, 128, 2, 32), (2, 256, 4, 64),
                                      (1, 96, 2, 8), (2, 64, 4, 16)])
def test_plain_matches_ref(B, S, H, hd, causal, dtype):
    (jq, jk, jv), (q, k, v) = _qkv(B, S, H, H, hd, S + H, dtype)
    want = ref.flash_attention_ref(jq, jk, jv, causal=causal)
    got = FA.flash_attention(q, k, v, causal=causal)
    assert got.dtype == q.dtype and got.shape == q.shape
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL[dtype])


@pytest.mark.parametrize("window", [32, 100])
def test_plain_sliding_window_matches_ref(window):
    (jq, jk, jv), (q, k, v) = _qkv(2, 256, 2, 2, 32, window)
    want = ref.flash_attention_ref(jq, jk, jv, causal=True,
                                   sliding_window=window)
    got = FA.flash_attention(q, k, v, causal=True, sliding_window=window)
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("H,KV", [(4, 4), (4, 2), (9, 3)])
def test_model_attention_matches_jax(H, KV, causal, dtype):
    """GQA through the model's entry point: JAX repeats KV heads, the port
    reads KV head h // (H // KV)."""
    (jq, jk, jv), (q, k, v) = _qkv(2, 128, H, KV, 16, 10 * H + KV, dtype)
    want = jattn.attention(jq, jk, jv, causal=causal, kv_block=32)
    got = tattn.attention(q, k, v, causal=causal)
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL[dtype])


@pytest.mark.parametrize("window", [16, 48])
def test_model_sliding_window_matches_jax(window):
    (jq, jk, jv), (q, k, v) = _qkv(1, 128, 4, 2, 16, window)
    want = jattn.attention(jq, jk, jv, causal=True, sliding_window=window,
                           q_block=32)
    got = tattn.attention(q, k, v, causal=True, sliding_window=window)
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL["float32"])


@pytest.mark.parametrize("S,window", [(128, 48), (96, 95), (64, 64),
                                      (48, 100)])
def test_model_non_causal_window_routes_as_jax(S, window):
    """``causal=False`` with a window: past S > window JAX's sliding-window
    path is causal whatever ``causal`` says; at S <= window it is the full
    non-causal path (the window never binds).  float32 tolerance 2e-5."""
    (jq, jk, jv), (q, k, v) = _qkv(1, S, 4, 2, 16, S + window)
    want = jattn.attention(jq, jk, jv, causal=False, sliding_window=window,
                           q_block=32, kv_block=32)
    got = tattn.attention(q, k, v, causal=False, sliding_window=window)
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL["float32"])
    plain = tattn.attention(q, k, v, causal=False, sliding_window=window,
                            use_kernel=False)
    torch.testing.assert_close(got, plain, rtol=0, atol=0)
    if S > window:    # the route attends to no future key
        causal = FA.flash_attention_plain(q, k, v, causal=True,
                                          sliding_window=window)
        torch.testing.assert_close(got, causal, rtol=0, atol=0)


@pytest.mark.parametrize("window", [0, 24])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [8, 16, 80, 256])
def test_plain_matches_ref_at_every_head_width(hd, dtype, window):
    """The head widths JAX's configs use beyond 64 and 128: 8 and 16 (the
    smoke configs), 80 (hubert-xlarge), 256 (gemma3-4b), GQA 4 over 2 on
    pre-repeated heads for the reference."""
    (jq, jk, jv), (q, k, v) = _qkv(2, 96, 4, 2, hd, hd + window, dtype)
    jk, jv = (jnp.repeat(a, 2, axis=2) for a in (jk, jv))
    want = ref.flash_attention_ref(jq, jk, jv, causal=True,
                                   sliding_window=window)
    got = FA.flash_attention(q, k, v, causal=True, sliding_window=window)
    assert got.dtype == q.dtype and got.shape == q.shape
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL[dtype])


@pytest.mark.parametrize("S,window", [(100, 0), (77, 20), (1, 0)])
def test_plain_ragged_s_matches_ref(S, window):
    """Any S (the TPU kernel asserts S % 128 == 0): GQA 9 over 3 against
    the reference on pre-repeated heads."""
    (jq, jk, jv), (q, k, v) = _qkv(1, S, 9, 3, 64, S)
    jk, jv = (jnp.repeat(a, 3, axis=2) for a in (jk, jv))
    want = ref.flash_attention_ref(jq, jk, jv, causal=True,
                                   sliding_window=window)
    got = FA.flash_attention(q, k, v, causal=True, sliding_window=window)
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL["float32"])


def test_decode_attention_matches_jax():
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 1, 4, 16)).astype(np.float32)
    kc = rng.standard_normal((2, 40, 2, 16)).astype(np.float32)
    vc = rng.standard_normal((2, 40, 2, 16)).astype(np.float32)
    for window in (0, 5):
        want = jattn.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                      jnp.asarray(vc), jnp.int32(23),
                                      sliding_window=window)
        got = tattn.decode_attention(torch.from_numpy(q), torch.from_numpy(kc),
                                     torch.from_numpy(vc), 23,
                                     sliding_window=window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                                   atol=2e-5)


def test_rope_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 12, 3, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(5, 17, dtype=np.int32)[None], (2, 12))
    want = jattn.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4)
    got = tattn.apply_rope(torch.from_numpy(x), torch.from_numpy(pos.copy()),
                           1e4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_cpu_takes_plain_and_counts_no_launch(monkeypatch):
    _, (q, k, v) = _qkv(1, 64, 2, 1, 64, 0)
    before = FA.launches
    calls = []
    real = FA.flash_attention_plain

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(FA, "flash_attention_plain", spy)
    FA.flash_attention(q, k, v)
    assert calls == [1] and FA.launches == before


@pytest.mark.parametrize("bad", ["dtype", "heads", "shape", "window"])
def test_wrapper_rejects_bad_inputs(bad):
    _, (q, k, v) = _qkv(1, 32, 4, 2, 64, 0)
    if bad == "dtype":
        k = k.double()
    elif bad == "heads":
        k, v = k[:, :, :1].repeat(1, 1, 3, 1), v[:, :, :1].repeat(1, 1, 3, 1)
    elif bad == "shape":
        k, v = k[:, :16], v[:, :16]
    with pytest.raises(ValueError):
        FA.flash_attention(q, k, v, sliding_window=-1 if bad == "window"
                           else 0)


_SM90 = ("flash_attention_sm90", "flash_attention_sm90_launch", 8)
_F32 = ("flash_attention_f32_sm90", "flash_attention_f32_sm90_launch", 8)
_BWD = {"bfloat16": ("flash_attention_bwd_sm90",
                     "flash_attention_bwd_sm90_launch"),
        "float32": ("flash_attention_bwd_f32_sm90",
                    "flash_attention_bwd_f32_sm90_launch")}


@pytest.mark.parametrize("dtype,hd,lib,symbol,ints", [
    ("bfloat16", 64, *_SM90),
    ("bfloat16", 128, *_SM90),
    ("float32", 64, *_F32),
    ("float32", 256, *_F32),
    ("bfloat16", 256, *_SM90),
    ("bfloat16", 80, *_SM90),
    ("bfloat16", 16, *_SM90),
    ("float32", 8, *_F32),
    ("float32", 80, *_F32),
    ("bfloat16", 8, *_SM90),
    ("float32", 16, *_F32),
    ("float32", 128, *_F32),
])
def test_launch_routes_by_dtype(monkeypatch, dtype, hd, lib, symbol, ints):
    """A fixed route by dtype at every width: bf16 goes to the wgmma/TMA
    kernel, float32 to the 3xTF32 one, each with five pointers (the lse
    output null unless asked for) and 8 ints (no dtype code); one launch,
    counted once in ``launches`` and in its kernel's ``kernel_launches``,
    and nothing else is tried.  Either entry is handed the real hd (8 and
    80 stay 8 and 80: the wgmma kernel pads its tiles itself).  Asked for
    the lse, the entry gets a (B, H, S) float32 buffer's pointer."""
    calls = []

    class Fn:
        argtypes = None

        def __call__(self, *args):
            calls.append((lib_name[0], args))
            return 0

    lib_name = []

    class Lib:
        def __init__(self, name):
            self.name = name

        def __getattr__(self, attr):
            if attr != symbol:
                raise AttributeError(attr)
            lib_name.append(self.name)
            return fns.setdefault(attr, Fn())

    fns = {}
    monkeypatch.setattr(FA.build, "load", Lib)
    monkeypatch.setattr(FA.build, "device_and_stream", lambda t: (0, 7))
    _, (q, k, v) = _qkv(2, 40, 4, 2, hd, 5, dtype)
    before = FA.launches
    by_kernel = dict(FA.kernel_launches)
    out = FA._launch(q, k, v, True, 16)
    assert FA.launches == before + 1
    assert FA.kernel_launches == {**by_kernel, lib: by_kernel[lib] + 1}
    assert out.shape == q.shape and out.dtype == q.dtype
    assert len(calls) == 1 and calls[0][0] == lib
    args = calls[0][1]
    assert len(fns[symbol].argtypes) == 5 + ints + 1
    assert args[3] == out.data_ptr() and args[4] is None
    assert args[5:12] == (2, 40, 4, 2, hd, 1, 16) and args[-2:] == (0, 7)
    assert len(args) == 5 + ints + 1
    out, lse = FA._launch(q, k, v, True, 16, return_lse=True)
    assert FA.launches == before + 2 and len(calls) == 2
    assert lse.shape == (2, 4, 40) and lse.dtype == torch.float32
    assert calls[1][1][4] == lse.data_ptr()
    assert calls[1][1][5:] == args[5:]


def test_route_by_dtype_and_width():
    """The whole route table: bf16 at 8, 16, 64, 80, 128 and 256 the
    wgmma kernel, float32 at the same widths the 3xTF32 kernel, the SIMT
    kernel at none; any other width raises in either dtype, and so does
    another dtype."""
    for hd in (64, 80, 128, 256):
        assert FA.route(torch.bfloat16, hd) is FA.SM90
    for hd in (8, 16):
        assert FA.route(torch.bfloat16, hd) is FA.SM90
    for hd in (8, 16, 64, 80, 128, 256):
        assert FA.route(torch.float32, hd) is FA.F32
        assert FA.SIMT not in (FA.route(torch.float32, hd),
                               FA.route(torch.bfloat16, hd))
    for dtype in (torch.bfloat16, torch.float32):
        for hd in (4, 32, 96, 512):
            with pytest.raises(ValueError, match="hd"):
                FA.route(dtype, hd)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        FA.route(torch.float16, 64)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 mantissa bits), to nearest with ties
    away from zero, as ``cvt.rna.tf32.f32``: half of the 13 dropped bits'
    range added to the magnitude, then the 13 bits cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm_tf32(a, b, terms):
    """a @ b in float32 from TF32 parts: 3xTF32 (``terms`` 3) as the
    float32 kernel takes it, al bh + ah bl + ah bh with hi = tf32(x) and
    lo = tf32(x - hi); or one TF32 product (``terms`` 1)."""
    ah, bh = _tf32(a), _tf32(b)
    if terms == 1:
        return ah @ bh
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _attention(q, k, v, mm):
    """Causal attention of one head, (S, hd), with the TPU kernel's
    masks; products through ``mm`` (S = q k^T and O = P V, P unnormalised
    as the kernel keeps it, divided by l after)."""
    S, hd = q.shape
    s = mm(q, k.T) * (1.0 / math.sqrt(hd))
    i = torch.arange(S)
    s = torch.where(i[:, None] >= i[None, :], s, FA.NEG_INF)
    p = torch.exp(s - s.max(-1, keepdim=True).values)
    return mm(p, v) / p.sum(-1, keepdim=True)


@pytest.mark.parametrize("hd", [8, 64, 256])
def test_3xtf32_split_keeps_float32_tolerance(hd):
    """The float32 kernel's arithmetic emulated on the CPU: both products
    of the attention in 3xTF32 (TF32 by bit masking, float32 sums) hold
    against float64 attention at the float32 kernels' tolerance (rtol =
    atol = 2e-5, ``tests/test_torch_cuda.py::FLASH_TOL``), so the card's
    kernel-vs-plain check is not passed by a tolerance picked after the
    fact; one TF32 product misses it by far."""
    rng = np.random.default_rng(hd)
    q, k, v = (torch.from_numpy(rng.standard_normal((300, hd))
                                .astype(np.float32)) for _ in range(3))
    want = _attention(q.double(), k.double(), v.double(), torch.matmul)
    three = _attention(q, k, v, lambda a, b: _mm_tf32(a, b, 3))
    np.testing.assert_allclose(three.double().numpy(), want.numpy(),
                               **TOL["float32"])
    one = _attention(q, k, v, lambda a, b: _mm_tf32(a, b, 1))
    assert float((one.double() - want).abs().max()) > 10 * 2e-5


@pytest.mark.parametrize("hd", [4, 32, 96, 512])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_launch_refuses_other_head_widths(monkeypatch, hd, dtype):
    """A width no kernel takes raises before anything is loaded or
    launched."""
    monkeypatch.setattr(FA.build, "load", lambda name: pytest.fail(name))
    _, (q, k, v) = _qkv(1, 16, 2, 2, hd, 8, dtype)
    before = FA.launches
    with pytest.raises(ValueError, match="hd"):
        FA._launch(q, k, v, True, 0)
    assert FA.launches == before


def test_launch_raises_on_a_failed_launch(monkeypatch):
    class Lib:
        def __getattr__(self, attr):
            fn = lambda *a: 719  # noqa: E731
            fn.argtypes = None
            return fn

    monkeypatch.setattr(FA.build, "load", lambda name: Lib())
    monkeypatch.setattr(FA.build, "device_and_stream", lambda t: (0, 0))
    _, (q, k, v) = _qkv(1, 16, 2, 2, 64, 6, "bfloat16")
    before = FA.launches
    with pytest.raises(RuntimeError, match="719"):
        FA._launch(q, k, v, True, 0)
    assert FA.launches == before


# ------------------------------------------------------------- backward --

def _bwd_args(hd, dtype, S=40, H=4, KV=2, seed=9):
    _, (q, k, v) = _qkv(2, S, H, KV, hd, seed, dtype)
    out, lse = FA.flash_attention_plain(q, k, v, return_lse=True)
    do = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        q.shape).astype(np.float32)).to(TORCH[dtype])
    return q, k, v, out.contiguous(), do, lse


def test_plain_out_is_the_same_with_lse():
    """``return_lse`` adds the log-sum-exp and leaves the output's bits."""
    for dtype in ("float32", "bfloat16"):
        _, (q, k, v) = _qkv(2, 40, 4, 2, 16, 3, dtype)
        out, lse = FA.flash_attention(q, k, v, sliding_window=8,
                                      return_lse=True)
        assert torch.equal(out, FA.flash_attention(q, k, v,
                                                   sliding_window=8))
        assert lse.shape == (2, 4, 40) and lse.dtype == torch.float32


def test_cpu_bwd_takes_plain_and_counts_no_launch(monkeypatch):
    q, k, v, out, do, lse = _bwd_args(16, "float32")
    calls = []
    real = FA.flash_attention_bwd_plain

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(FA, "flash_attention_bwd_plain", spy)
    monkeypatch.setattr(FA.build, "load", lambda name: pytest.fail(name))
    before = FA.bwd_launches
    dq, dk, dv = FA.flash_attention_bwd(q, k, v, out, do, lse)
    assert calls == [1] and FA.bwd_launches == before
    assert dq.shape == q.shape and dk.shape == dv.shape == k.shape


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [8, 16, 64, 80, 128, 256])
def test_bwd_launch_passes_the_shape_and_counts(monkeypatch, dtype, hd):
    """One call of the routed backward entry per backward (bf16 the wgmma
    library, float32 the 3xTF32 one; nothing else is loaded): ten pointers
    (q, k, v, out, dout, lse, dq, dk, dv and the 2 B H Sp float32 scratch
    of lse in log2 units and D, Sp = S rounded up to 64), then B, S, H, KV,
    hd, causal, window and the device, then the stream; ``bwd_launches``
    and the library's ``bwd_kernel_launches`` count its three launches."""
    calls = []
    lib, symbol = _BWD[dtype]

    class Fn:
        argtypes = None

        def __call__(self, *args):
            calls.append(args)
            return 0

    fn = Fn()

    class Lib:
        def __getattr__(self, attr):
            if attr != symbol:
                raise AttributeError(attr)
            return fn

    monkeypatch.setattr(FA.build, "load", lambda name: (
        Lib() if name == lib else pytest.fail(name)))
    monkeypatch.setattr(FA.build, "device_and_stream", lambda t: (0, 7))
    monkeypatch.setattr(FA.torch, "empty", _spy_empty(seen := []))
    q, k, v, out, do, lse = _bwd_args(hd, dtype)
    assert FA.bwd_route(TORCH[dtype], hd) == (lib, symbol)
    before = FA.bwd_launches, dict(FA.bwd_kernel_launches)
    dq, dk, dv = FA._launch_bwd(q, k, v, out, do, lse, False, 12)
    assert FA.bwd_launches == before[0] + FA.BWD_LAUNCHES_PER_CALL
    assert FA.BWD_LAUNCHES_PER_CALL == 3
    assert FA.bwd_kernel_launches == {**before[1], lib: before[1][lib] + 3}
    assert len(calls) == 1 and len(fn.argtypes) == 19
    args = calls[0]
    assert args[0] == q.data_ptr() and args[3] == out.data_ptr()
    assert args[4] == do.data_ptr() and args[5] == lse.data_ptr()
    assert args[6] == dq.data_ptr() and args[8] == dv.data_ptr()
    assert seen == [2 * 2 * 4 * 64]      # the scratch: 2 B H Sp floats
    assert args[10:] == (2, 40, 4, 2, hd, 0, 12, 0, 7)
    assert dq.dtype == dk.dtype == dv.dtype == q.dtype
    assert dk.shape == dv.shape == k.shape


def _spy_empty(seen):
    """torch.empty that records the size of each 1-D float32 buffer."""
    real = torch.empty

    def empty(*size, **kw):
        if kw.get("dtype") == torch.float32 and len(size) == 1:
            seen.append(size[0])
        return real(*size, **kw)
    return empty


def test_bwd_route_by_dtype_and_width():
    """The backward's route table: bf16 the wgmma library, float32 the
    3xTF32 one, at every width; the SIMT backward at none; another width
    or dtype raises."""
    for hd in FA.HEAD_DIMS:
        assert FA.bwd_route(torch.bfloat16, hd) is FA.BWD_SM90
        assert FA.bwd_route(torch.float32, hd) is FA.BWD_F32
    assert FA.BWD_SIMT not in (FA.BWD_SM90, FA.BWD_F32)
    for hd in (4, 32, 96, 512):
        with pytest.raises(ValueError, match="hd"):
            FA.bwd_route(torch.bfloat16, hd)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        FA.bwd_route(torch.float16, 64)


@pytest.mark.parametrize("hd", [4, 32, 96])
def test_bwd_launch_refuses_other_widths(monkeypatch, hd):
    monkeypatch.setattr(FA.build, "load", lambda name: pytest.fail(name))
    q, k, v, out, do, lse = _bwd_args(hd, "bfloat16")
    before = FA.bwd_launches
    with pytest.raises(ValueError, match="hd"):
        FA._launch_bwd(q, k, v, out, do, lse, True, 0)
    assert FA.bwd_launches == before


def test_bwd_launch_raises_on_a_failed_launch_or_strided_input(monkeypatch):
    class Lib:
        def __getattr__(self, attr):
            fn = lambda *a: 701  # noqa: E731
            fn.argtypes = None
            return fn

    monkeypatch.setattr(FA.build, "load", lambda name: Lib())
    monkeypatch.setattr(FA.build, "device_and_stream", lambda t: (0, 0))
    for dtype in ("float32", "bfloat16"):
        q, k, v, out, do, lse = _bwd_args(64, dtype)
        before = FA.bwd_launches, dict(FA.bwd_kernel_launches)
        with pytest.raises(RuntimeError, match="701"):
            FA._launch_bwd(q, k, v, out, do, lse, True, 0)
        with pytest.raises(ValueError, match="dout must be contiguous"):
            FA._launch_bwd(q, k, v, out, do.transpose(1, 2).contiguous()
                           .transpose(1, 2), lse, True, 0)
        with pytest.raises(ValueError, match="lse must be contiguous"):
            FA._launch_bwd(q, k, v, out, do, lse.transpose(1, 2)
                           .contiguous().transpose(1, 2), True, 0)
        assert (FA.bwd_launches, FA.bwd_kernel_launches) == before


def test_model_attention_routes_training_through_the_autograd_function(
        monkeypatch):
    """With grad on, the kernel route is ``FlashAttention`` (window and
    causal routed as in inference: a binding window forces causal, one
    that does not bind is dropped); under ``no_grad`` it is the forward
    wrapper; ``use_kernel=False`` stays the plain version either way."""
    seen = []
    monkeypatch.setattr(FA.FlashAttention, "apply",
                        lambda *a: seen.append(("fn",) + a[3:]) or a[0])
    real = FA.flash_attention
    monkeypatch.setattr(FA, "flash_attention", lambda *a, **kw: seen.append(
        ("fwd", kw["causal"], kw["sliding_window"])) or real(*a, **kw))
    _, (q, k, v) = _qkv(1, 64, 2, 2, 16, 1)
    tattn.attention(q, k, v, causal=False, sliding_window=32)
    tattn.attention(q, k, v, causal=False, sliding_window=100)
    with torch.no_grad():
        tattn.attention(q, k, v, causal=False, sliding_window=32)
    tattn.attention(q, k, v, causal=True, use_kernel=False)
    assert seen == [("fn", True, 32), ("fn", False, 0), ("fwd", True, 32)]
