"""The port's CUDA kernels and device paths against their plain versions.

Only torch and ``repro_torch`` are imported here (no JAX), so this file
runs on a machine with a card: ``python -m pytest -m cuda
tests/test_torch_cuda.py``.  Without a card the ``cuda`` tests skip.
"""
import ctypes
import shutil

import numpy as np
import pytest
import torch

from repro_torch.cluster import state as tstate
from repro_torch.cluster.fleet import make_fleet
from repro_torch.cluster.simulator import Cluster
from repro_torch.cluster.workloads import Pod, online_arrays
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import build, scan_function
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import rollout_tick as RT
from repro_torch.kernels import runqlat_hist as K
from repro_torch.kernels import rwkv_wkv as WKV
from repro_torch.kernels import ssd as SSD
from repro_torch.models import rwkv as trwkv
from repro_torch.models.model import Model
from repro_torch.serve import ServeEngine


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _inputs(S, N, seed, device, zero_one=True):
    g = torch.Generator().manual_seed(seed)
    s = torch.rand((S, N), generator=g) * 1210.0 - 10.0
    if zero_one:
        w = (torch.rand((S, 1), generator=g) < 0.6).float().expand(S, N)
    else:
        w = torch.rand((S, N), generator=g) * (torch.rand((S, N), generator=g) < 0.8)
    return s.to(device), w.contiguous().to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [8000, 6000])
def test_kernel_equals_plain_at_main_path_shapes(card, S):
    s, w = _inputs(S, 16, S, card)
    before = K.launches
    got = K.runqlat_hist(s, w)
    torch.cuda.synchronize()
    assert K.launches == before + 1
    torch.testing.assert_close(got, K.runqlat_hist_plain(s, w), rtol=0, atol=0)
    torch.testing.assert_close(got.sum(-1), w.sum(-1), rtol=0, atol=0)
    torch.testing.assert_close(K.runqlat_hist(s), K.runqlat_hist_plain(s),
                               rtol=0, atol=0)


@pytest.mark.cuda
def test_kernel_ragged_float_weights(card):
    """General float weights: the atomics add in no fixed order, so the
    result agrees to float32 rounding, not bit for bit."""
    s, w = _inputs(64, 5003, 1, card, zero_one=False)
    torch.testing.assert_close(K.runqlat_hist(s, w), K.runqlat_hist_plain(s, w),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
def test_cuda_tensor_never_takes_the_plain_version(card, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("plain version called for a CUDA tensor")

    s, w = _inputs(10, 16, 2, card)
    monkeypatch.setattr(K, "runqlat_hist_plain", refuse)
    K.runqlat_hist(s, w)
    with pytest.raises(ValueError):
        K.runqlat_hist(s, w.cpu())                 # mixed devices


def _mask_set(S, n, seed, device):
    """(S, n) samples and a 0/1 weight a series broadcast along its samples
    (stride 0), as the tick hands its slot masks to the kernel."""
    g = torch.Generator().manual_seed(seed)
    s = torch.rand((S, n), generator=g) * 1210.0 - 10.0
    m = (torch.rand((S, 1), generator=g) < 0.6).float()
    return s.to(device), m.to(device).expand(S, n)


@pytest.mark.cuda
def test_segments_kernel_equals_plain_in_one_launch(card):
    """Four sets in one launch: n 16 with broadcast masks and a series count
    that is not a multiple of a block's 8, n 33 and n 5003 (the
    shared-memory path) with 0/1 weights, n 7 unweighted: each equal to the
    plain version bit for bit."""
    sets = [_mask_set(8001, 16, 1, card), _mask_set(37, 33, 2, card),
            _mask_set(5, 5003, 3, card),
            (_mask_set(13, 7, 4, card)[0], None)]
    assert sets[0][1].stride(1) == 0
    before = K.launches
    got = K.runqlat_hist_segments(sets)
    torch.cuda.synchronize()
    assert K.launches == before + 1
    for (s, w), h in zip(sets, got):
        want = K.runqlat_hist_plain(s, None if w is None else w.contiguous())
        torch.testing.assert_close(h, want, rtol=0, atol=0)
    torch.testing.assert_close(got[0].sum(-1), sets[0][1].sum(-1), rtol=0,
                               atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 16, 32])
def test_short_series_float_weights_equal_sequential_plain(card, n):
    """A warp sums each bin in sample order: general float weights (zeros
    among them) equal the CPU's sequential scatter-add bit for bit."""
    s, w = _inputs(1003, n, n, card, zero_one=False)
    got = K.runqlat_hist(s, w).cpu()
    torch.testing.assert_close(got, K.runqlat_hist_plain(s.cpu(), w.cpu()),
                               rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [16, 100])
def test_zero_weights_add_nothing(card, n):
    s, _ = _inputs(50, n, 5, card)
    w = torch.zeros_like(s)
    w[::2] = 1.0
    got = K.runqlat_hist(s, w)
    assert float(got[1::2].abs().sum()) == 0.0
    torch.testing.assert_close(got.sum(-1), w.sum(-1), rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["too_many", "dtype", "weight_shape",
                                 "devices", "dims"])
def test_segments_wrapper_raises_on_bad_inputs(card, bad):
    s, w = _mask_set(10, 16, 6, card)
    sets = {"too_many": [(s, w)] * (K.MAX_SEGMENTS + 1),
            "dtype": [(s, w), (s.double(), None)],
            "weight_shape": [(s, w[:, :15])],
            "devices": [(s, w), (s.cpu(), None)],
            "dims": [(s[None], None)]}[bad]
    before = K.launches
    with pytest.raises(ValueError):
        K.runqlat_hist_segments(sets)
    assert K.launches == before


@pytest.mark.cuda
def test_ticks_on_card_match_cpu_with_the_same_noise(card):
    c = Cluster(fleet=make_fleet(40, seed=0), seed=0, device=card)
    rng = np.random.default_rng(0)
    for i in range(60):
        pod = Pod("web_search", float(rng.uniform(50, 900)), True)
        if i % 3 == 0:
            pod = Pod("graph_analytics", 0.0, False, duration=int(rng.integers(3, 30)))
            pod.cpu_demand = 4.0
        c.place(pod, i % 40)
    gen = torch.Generator(device=card).manual_seed(1)
    noise = tstate.draw_noise(gen, c.n, 10)
    cpu = torch.device("cpu")

    def on(dev, tree):
        return {k: v.to(dev) for k, v in tree.items()}

    gst, gout = tstate._window_core(c.state, c.profiles, c.fleet_params, 50.0,
                                    noise)
    cst, cout = tstate._window_core(
        tstate.ClusterState(**on(cpu, vars(c.state))),
        on(cpu, c.profiles),
        tstate.FleetParams(**on(cpu, vars(c.fleet_params))), 50.0,
        [tstate.TickNoise(**on(cpu, vars(n))) for n in noise])
    for k, v in vars(gst).items():
        torch.testing.assert_close(v.cpu(), getattr(cst, k), rtol=0, atol=0)
    for k, v in gout.items():
        if k.startswith("hist"):
            torch.testing.assert_close(v.sum(-1).cpu(), cout[k].sum(-1),
                                       rtol=0, atol=0)
        else:
            torch.testing.assert_close(v.cpu(), cout[k], rtol=1e-5, atol=1e-5)


def _packed_tick(rows, seed, device):
    """``fused_tick`` inputs as ``_tick_fused`` packs them, drawn with a
    CPU generator: pressures across the knee, ~60% of slots active."""
    g = torch.Generator().manual_seed(seed)

    def u(*shape, lo=0.0, hi=1.0):
        return torch.rand(shape, generator=g) * (hi - lo) + lo

    nodev = torch.stack([
        u(rows, lo=0.05, hi=1.3), u(rows, lo=2.0, hi=60.0),
        torch.tensor([16.0, 32.0, 96.0])[torch.randint(3, (rows,), generator=g)],
        u(rows, lo=2.0, hi=4.0), u(rows, lo=40.0, hi=70.0),
        torch.full((rows,), 0.05), u(rows, lo=0.1, hi=0.2),
        torch.randn((rows,), generator=g)], dim=-1)
    jit = 1.0 + 0.18 * torch.randn((rows, 14), generator=g)
    act = (u(rows, 14) < 0.6).float()
    tiny = float(np.finfo(np.float32).tiny)
    u1, u2 = (u(rows, 224).clamp_min_(tiny) for _ in range(2))
    return [t.contiguous().to(device) for t in (nodev, jit, act, u1, u2)]


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [20000, 37])
def test_fused_kernel_equals_plain(card, rows):
    """R = 20,000 is a 20-seed x 1,000-node batched tick; 37 is ragged.
    Histograms bit for bit; delay and mean within 1e-6 relative."""
    inp = _packed_tick(rows, rows, card)
    before = RT.launches
    hist, delay, mean = RT.fused_tick(*inp)
    torch.cuda.synchronize()
    assert RT.launches == before + 1
    want = RT.fused_tick_plain(*inp)
    torch.testing.assert_close(hist, want[0], rtol=0, atol=0)
    torch.testing.assert_close(hist.sum(-1), inp[2].sum(-1) * 16,
                               rtol=0, atol=0)
    torch.testing.assert_close(delay, want[1], rtol=1e-6, atol=0)
    torch.testing.assert_close(mean, want[2], rtol=1e-6, atol=0)


def _unpacked_tick(rows, seed, device):
    """``fused_tick_unpacked`` inputs as ``_tick_fused`` hands them over:
    (R,) fields, the delay column of a noise bundle's normals block, its
    jitter and uniform views (the bulk draws' row strides), bool masks."""
    nodev = _packed_tick(rows, seed, device)[0]
    gen = torch.Generator(device=device).manual_seed(seed)
    noise = tstate.draw_noise(gen, rows, 1)[0]
    g = torch.Generator().manual_seed(seed + 1)
    on = (torch.rand((rows, tstate.S_ON), generator=g) < 0.6).to(device)
    off = (torch.rand((rows, tstate.S_OFF), generator=g) < 0.4).to(device)
    fields = [nodev[:, f].contiguous() for f in range(7)] + [noise.delay]
    return (fields, noise.jit_on, noise.jit_off, on, off, noise.u_on,
            noise.u_off)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [20000, 37])
def test_unpacked_fused_kernel_equals_plain(card, rows):
    """The main path's entry, reading the tick's tensors where they lie:
    histograms bit for bit, delay and mean within 1e-6 relative."""
    inp = _unpacked_tick(rows, rows, card)
    assert not inp[5].is_contiguous()
    before = RT.launches
    hist, delay, mean = RT.fused_tick_unpacked(*inp)
    torch.cuda.synchronize()
    assert RT.launches == before + 1
    want = RT.fused_tick_unpacked_plain(*inp)
    torch.testing.assert_close(hist, want[0], rtol=0, atol=0)
    act = torch.cat([inp[3], inp[4]], 1).float()
    torch.testing.assert_close(hist.sum(-1), act.sum(-1) * 16, rtol=0, atol=0)
    torch.testing.assert_close(delay, want[1], rtol=1e-6, atol=0)
    torch.testing.assert_close(mean, want[2], rtol=1e-6, atol=0)


@pytest.mark.cuda
def test_fused_cuda_tensor_never_takes_the_plain_version(card, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("plain version called for a CUDA tensor")

    inp = _packed_tick(9, 0, card)
    monkeypatch.setattr(RT, "fused_tick_plain", refuse)
    RT.fused_tick(*inp)
    with pytest.raises(ValueError):
        RT.fused_tick(*inp[:4], inp[4].cpu())        # mixed devices


_LOG = [("place_on", 0.0, n, s, (n + s) % 4, 150.0 + 40 * s, 0.3 * n)
        for n in range(12) for s in range(3)] + [
    ("place_off", 10.0, n, 0, 8.0, 12.8, 20.0, 1.8, 60) for n in range(0, 12, 2)
] + [("migrate_on", 30.0, 0, 0, 13, 0), ("evict_on", 50.0, 1, 1)]


def _replay(device, noise, fused=True):
    events = tstate.extract_plan(_LOG, 0.0, 3, 2)
    profiles = {k: torch.as_tensor(v, device=device)
                for k, v in online_arrays().items()}
    return tstate.batched_rollout(
        tstate.ClusterState.create(16, device=device), profiles, 0.0,
        noise, events, use_fused=fused)


@pytest.mark.cuda
def test_fused_batched_rollout_card_matches_cpu(card):
    """Three seeds x 16 nodes on the fused path, the same draws on both."""
    streams = []
    for s in range(3):
        gen = torch.Generator(device=card).manual_seed(s)
        streams.append([tstate.draw_noise(gen, 16, 10) for _ in range(6)])
    gfinal, gout = _replay(card, streams)
    cpu = torch.device("cpu")
    cstreams = [[[tstate.TickNoise(**{k: v.to(cpu) for k, v in vars(n).items()})
                  for n in chunk] for chunk in st] for st in streams]
    cfinal, cout = _replay(cpu, cstreams)
    for k, v in vars(gfinal["state"]).items():
        torch.testing.assert_close(v.cpu(), getattr(cfinal["state"], k),
                                   rtol=0, atol=0)
    torch.testing.assert_close(gout["hot"].cpu(), cout["hot"], rtol=0, atol=0)
    for k in ("rt", "qps", "cpu_util", "mem_util"):
        torch.testing.assert_close(gout[k].cpu(), cout[k], rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.cuda
def test_one_fused_launch_per_batched_tick(card):
    streams = [tstate.SeedNoise(s, 16, card) for s in range(4)]
    fused, hist = RT.launches, K.launches
    _replay(card, streams)
    torch.cuda.synchronize()
    assert RT.launches - fused == 3 * 2 * 10      # windows x chunks x ticks
    assert K.launches == hist


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    """No compiler means an error, never a quiet fallback."""
    if shutil.which("nvcc") or torch.cuda.is_available():
        pytest.skip("a CUDA toolchain is present")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(build, "_loaded", {})
    with pytest.raises(RuntimeError, match="nvcc"):
        build.load("runqlat_hist")


@pytest.fixture
def exact_f32():
    """float32 products in full float32 (no TF32) for the plain versions."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = old


def _qkv(B, S, H, KV, hd, dtype, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn((B, S, h, hd), generator=g).to(dtype).to(device)
            for h in (H, KV, KV)]


# bfloat16 output: the kernel and the plain version round the same float32
# value, which differs in its last float32 bits, so a bf16 ulp at most.
FLASH_TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
             torch.bfloat16: dict(rtol=1e-2, atol=1e-2)}


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,KV,hd,dtype,causal,window", [
    (2, 256, 4, 4, 64, torch.bfloat16, True, 0),
    (1, 1000, 9, 3, 64, torch.float32, True, 0),
    (1, 1000, 9, 3, 64, torch.float32, True, 100),
    (1, 77, 2, 1, 128, torch.float32, False, 0),
    (2, 130, 4, 2, 128, torch.bfloat16, True, 0),
    (1, 300, 2, 2, 64, torch.float32, False, 50),
])
def test_flash_kernel_equals_plain(card, exact_f32, B, S, H, KV, hd, dtype,
                                   causal, window):
    q, k, v = _qkv(B, S, H, KV, hd, dtype, card, seed=S + H)
    before = FA.launches
    got = FA.flash_attention(q, k, v, causal=causal, sliding_window=window)
    torch.cuda.synchronize()
    assert FA.launches == before + 1
    want = FA.flash_attention_plain(q, k, v, causal=causal,
                                    sliding_window=window)
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), **FLASH_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("H,KV,B", [(32, 32, 4), (9, 3, 1)])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0),
                                           (True, 100)])
@pytest.mark.parametrize("S", [1024, 1000, 77, 1])
@pytest.mark.parametrize("hd", [8, 16, 64, 80, 128, 256])
def test_flash_sm90_kernel_equals_plain(card, exact_f32, hd, S, causal,
                                        window, H, KV, B):
    """The bf16 wgmma/TMA kernel against its plain version at the bf16
    limits of ``chip_smoke.py`` (its P is rounded to bf16 before P V), at
    every width it takes: 64 and 128 in tiles of 128 keys, 8, 16 and 80 in
    tiles of 64 or 128 columns zero-filled past hd, 256 in tiles of 64
    keys."""
    q, k, v = _qkv(B, S, H, KV, hd, torch.bfloat16, card, seed=S + hd + H)
    assert FA.route(torch.bfloat16, hd) is FA.SM90
    before = FA.launches
    got = FA.flash_attention(q, k, v, causal=causal, sliding_window=window)
    torch.cuda.synchronize()
    assert FA.launches == before + 1
    want = FA.flash_attention_plain(q, k, v, causal=causal,
                                    sliding_window=window)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(),
                               **FLASH_TOL[torch.bfloat16])


@pytest.mark.cuda
@pytest.mark.parametrize("H,KV,B", [(4, 2, 2), (9, 3, 1)])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0),
                                           (True, 100)])
@pytest.mark.parametrize("S", [1000, 300, 77, 1])
@pytest.mark.parametrize("hd", [8, 16, 64, 80, 128, 256])
def test_flash_f32_kernel_equals_plain(card, exact_f32, hd, S, causal,
                                       window, H, KV, B):
    """The float32 3xTF32 kernel against its plain version (float32
    products, TF32 off) at the float32 limits, at every width: 64 query
    rows a block in 64-key tiles, 128 rows in 32-key tiles at hd 256;
    ragged S, GQA, causal, non-causal and windowed."""
    q, k, v = _qkv(B, S, H, KV, hd, torch.float32, card, seed=S + hd + H)
    assert FA.route(torch.float32, hd) is FA.F32
    before = FA.launches
    got = FA.flash_attention(q, k, v, causal=causal, sliding_window=window)
    torch.cuda.synchronize()
    assert FA.launches == before + 1
    want = FA.flash_attention_plain(q, k, v, causal=causal,
                                    sliding_window=window)
    assert got.dtype == torch.float32 and got.shape == q.shape
    torch.testing.assert_close(got, want, **FLASH_TOL[torch.float32])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0),
                                           (True, 100)])
@pytest.mark.parametrize("S", [1, 77, 300])
@pytest.mark.parametrize("hd", [8, 16, 80, 256])
def test_flash_simt_kernel_at_every_width_equals_plain(card, exact_f32, hd, S,
                                                      causal, window, dtype):
    """The SIMT kernel at the widths beyond 64 and 128 (the smoke configs'
    8 and 16, hubert's 80, gemma3's 256), both dtypes, GQA 4 over 2.  The
    wrapper routes no pair to it any more, so every pair calls its entry
    directly (as ``chip_smoke.py`` does to time it beside the kernels that
    replaced it), which counts no launch."""
    q, k, v = _qkv(2, S, 4, 2, hd, dtype, card, seed=S + hd)
    assert FA.route(dtype, hd) is not FA.SIMT
    before = FA.launches
    got = torch.empty_like(q)
    dev, stream = build.device_and_stream(q)
    err = FA._entry(FA.SIMT)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), got.data_ptr(), 2, S, 4,
        2, hd, int(causal), window, FA._DTYPES[dtype], dev, stream)
    torch.cuda.synchronize()
    assert err == 0 and FA.launches == before
    want = FA.flash_attention_plain(q, k, v, causal=causal,
                                    sliding_window=window)
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), **FLASH_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1100, 1024])
def test_model_attention_at_gemma3_widths_equals_plain(card, exact_f32, S):
    """``models.attention.attention`` at gemma3-4b's widths (H 8 over KV
    4, hd 256, bf16): its local layers' window of 1,024 binds at S 1,100
    and not at S 1,024 (the full causal path), its global layers have
    none; the kernel path (the wgmma kernel) against ``use_kernel=False``
    at the bf16 limits."""
    from repro_torch.models import attention as tattn

    q, k, v = _qkv(2, S, 8, 4, 256, torch.bfloat16, card, seed=S)
    for window in (1024, 0):
        before = FA.launches
        got = tattn.attention(q, k, v, causal=True, sliding_window=window)
        torch.cuda.synchronize()
        assert FA.launches == before + 1
        want = tattn.attention(q, k, v, causal=True, sliding_window=window,
                               use_kernel=False)
        torch.testing.assert_close(got.float(), want.float(),
                                   **FLASH_TOL[torch.bfloat16])


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["hd", "contiguous", "dtype", "device"])
def test_flash_wrapper_raises_on_bad_inputs(card, bad):
    q, k, v = _qkv(1, 64, 2, 2, 64, torch.float32, card)
    if bad == "hd":
        q, k, v = _qkv(1, 64, 2, 2, 32, torch.float32, card)
    elif bad == "contiguous":
        q = q.transpose(1, 2).contiguous().transpose(1, 2)
    elif bad == "dtype":
        q, k, v = (t.half() for t in (q, k, v))
    else:
        k = k.cpu()
    with pytest.raises(ValueError):
        FA.flash_attention(q, k, v)


def _ssd_inputs(B, T, H, P, N, dtype, device, seed=0, a_range=(0.5, 2.0)):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((B, T, H, P), generator=g)
    dt = torch.rand((B, T, H), generator=g) * 0.19 + 0.01
    lo, hi = a_range
    A = -(torch.rand((H,), generator=g) * (hi - lo) + lo)
    Bm = torch.randn((B, T, N), generator=g)
    Cm = torch.randn((B, T, N), generator=g)
    return (x.to(dtype).to(device), dt.to(device), A.to(device),
            Bm.to(dtype).to(device), Cm.to(dtype).to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,P,N,dtype", [
    (2, 1024, 8, 64, 64, torch.bfloat16),
    (1, 1000, 4, 64, 64, torch.float32),
    (2, 37, 3, 16, 8, torch.float32),
    (1, 130, 2, 32, 16, torch.bfloat16),
])
def test_ssd_kernel_equals_plain(card, exact_f32, B, T, H, P, N, dtype):
    """y within a bf16 ulp (float32: 1e-4; both sum the same float32 terms
    in another order), the final float32 state within 1e-4."""
    inp = _ssd_inputs(B, T, H, P, N, dtype, card, seed=T)
    before = SSD.launches
    y, state = SSD.ssd(*inp)
    torch.cuda.synchronize()
    assert SSD.launches == before + 1
    wy, wstate = SSD.ssd_plain(*inp)
    tol = dict(rtol=1e-2, atol=1e-2) if dtype == torch.bfloat16 else \
        dict(rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(y.float(), wy.float(), **tol)
    torch.testing.assert_close(state, wstate, rtol=1e-4, atol=1e-4)


# bf16 goes to the tensor-core kernel (csrc/ssd_sm90.cu): zamba2-1.2b's
# prefill (A in [-16, -1], as the model's init), H = 5 (a group of heads
# past H, masked), N 16 (the served smoke model's P 64, N 16), and T of 1,
# 37, 64, 65 and 1,000 (ragged last chunks); float32 stays on ssd.cu
@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,P,N,a_range", [
    (4, 1024, 64, 64, 64, (1.0, 16.0)),
    (2, 256, 5, 64, 64, (0.5, 2.0)),
    (2, 200, 2, 64, 16, (1.0, 16.0)),
    (2, 1, 4, 32, 16, (0.5, 2.0)),
    (2, 37, 4, 32, 16, (0.5, 2.0)),
    (2, 64, 4, 32, 16, (0.5, 2.0)),
    (2, 65, 4, 32, 16, (0.5, 2.0)),
    (1, 1000, 6, 64, 64, (1.0, 16.0)),
])
def test_ssd_sm90_equals_plain(card, exact_f32, B, T, H, P, N, a_range):
    """y within a bf16 ulp and the final float32 state within 1e-4 of the
    plain version; one launch per call."""
    inp = _ssd_inputs(B, T, H, P, N, torch.bfloat16, card, seed=T + H,
                      a_range=a_range)
    before = SSD.launches
    y, state = SSD.ssd(*inp)
    torch.cuda.synchronize()
    assert SSD.launches == before + 1
    wy, wstate = SSD.ssd_plain(*inp)
    torch.testing.assert_close(y.float(), wy.float(), rtol=1e-2, atol=1e-2)
    torch.testing.assert_close(state, wstate, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_ssd_sm90_is_deterministic(card):
    """The chain sums in a fixed order: two calls give the same bits."""
    inp = _ssd_inputs(2, 1000, 8, 64, 64, torch.bfloat16, card, seed=3,
                      a_range=(1.0, 16.0))
    y1, s1 = SSD.ssd(*inp)
    y2, s2 = SSD.ssd(*inp)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2) and torch.equal(s1, s2)


@pytest.mark.cuda
@pytest.mark.parametrize("P,N", [(24, 16), (64, 8)])
def test_ssd_sm90_refuses_what_it_does_not_take(card, P, N):
    """A bf16 shape the tensor-core kernel does not take raises; it is not
    sent to the SIMT kernel."""
    inp = _ssd_inputs(1, 64, 2, P, N, torch.bfloat16, card)
    before = SSD.launches
    with pytest.raises(ValueError):
        SSD.ssd(*inp)
    assert SSD.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["P", "dt_dtype", "contiguous"])
def test_ssd_wrapper_raises_on_bad_inputs(card, bad):
    x, dt, A, Bm, Cm = _ssd_inputs(1, 64, 2, 16, 8, torch.float32, card)
    if bad == "P":
        x, dt, A, Bm, Cm = _ssd_inputs(1, 64, 2, 96, 8, torch.float32, card)
    elif bad == "dt_dtype":
        dt = dt.bfloat16()
    else:
        x = x.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError):
        SSD.ssd(x, dt, A, Bm, Cm)


@pytest.mark.cuda
def test_small_serve_run_goes_through_both_kernels(card):
    """The zamba2 smoke model as configured (hd 16, the wgmma flash kernel;
    P 16, N 16, the tensor-core SSD kernel): one cohort's prefill launches
    each kernel once per layer that runs it, and decode launches none."""
    cfg = get_smoke_config("zamba2-1.2b")
    model = Model(cfg, device=card).init_params(
        torch.Generator(device=card).manual_seed(0))
    eng = ServeEngine(model, max_batch=4)
    rng = np.random.default_rng(0)
    for _ in range(4):
        eng.submit(rng.integers(0, cfg.vocab_size, int(rng.integers(5, 90))),
                   max_new_tokens=4)
    fa, ssd = FA.launches, SSD.launches
    stats = eng.run()
    assert stats["finished"] == 4
    assert all(len(r.tokens) == 4 for r in eng.finished)
    assert FA.launches - fa == 2           # shared-attention applications
    assert SSD.launches - ssd == 5         # mamba layers


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["smollm-135m", "deepseek-coder-33b",
                                  "internlm2-20b", "gemma3-4b",
                                  "qwen3-moe-235b-a22b", "dbrx-132b"])
def test_small_serve_run_of_every_attention_model(card, arch):
    """Each attention model's smoke config (hd 8 or 16) served on the card:
    one flash launch per layer per cohort, none at decode; prompts up to 89
    tokens, so gemma3's window of 32 binds."""
    cfg = get_smoke_config(arch)
    model = Model(cfg, device=card).init_params(
        torch.Generator(device=card).manual_seed(0))
    eng = ServeEngine(model, max_batch=4)
    rng = np.random.default_rng(1)
    for _ in range(6):
        eng.submit(rng.integers(0, cfg.vocab_size, int(rng.integers(5, 90))),
                   max_new_tokens=4)
    before = FA.launches
    stats = eng.run()
    assert stats["finished"] == 6
    assert all(len(r.tokens) == 4 for r in eng.finished)
    assert FA.launches - before == 2 * cfg.num_layers   # two cohorts


def _grid_positions(B, n, grid):
    """(3, B, n) M-RoPE positions: a ``grid`` x ``grid`` image at t 0,
    h = row, w = col, then text from ``grid`` on in all three streams."""
    r = torch.arange(grid * grid) // grid
    c = torch.arange(grid * grid) % grid
    text = grid + torch.arange(n - grid * grid)
    pos = torch.stack([torch.cat([torch.zeros_like(r), text]),
                       torch.cat([r, text]), torch.cat([c, text])])
    return pos[:, None].expand(3, B, n).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2-vl-72b", "hubert-xlarge"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_embedding_input_models_kernel_path_equals_plain(card, exact_f32,
                                                        arch, dtype):
    """The qwen2-vl (image-grid M-RoPE positions, causal) and hubert
    (non-causal) smoke configs on the card: one flash launch per layer a
    forward, and the kernel path's logits against ``use_kernels=False``."""
    import dataclasses

    cfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype)
    model = Model(cfg, device=card).init_params(
        torch.Generator(device=card).manual_seed(0))
    g = torch.Generator().manual_seed(4)
    x = torch.randn((2, 200, cfg.d_model), generator=g).to(card)
    kw = {"embeds": x}
    if cfg.mrope_sections:
        kw["positions"] = _grid_positions(2, 200, 8).to(card)
    before = FA.launches
    got = model(**kw)
    torch.cuda.synchronize()
    assert FA.launches - before == cfg.num_layers
    model.cfg = dataclasses.replace(cfg, use_kernels=False)
    want = model(**kw)
    assert FA.launches - before == cfg.num_layers
    tol = (dict(rtol=5e-2, atol=1e-1) if dtype == torch.bfloat16
           else dict(rtol=1e-4, atol=1e-4))
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_non_causal_at_hubert_width_equals_plain(card, exact_f32,
                                                       dtype):
    """hubert-xlarge's attention (16 heads, hd 80, non-causal) at B 2, S
    1,000: every key attends, so the KV loop runs past the diagonal."""
    q, k, v = _qkv(2, 1000, 16, 16, 80, dtype, card, seed=80)
    before = FA.launches
    got = FA.flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert FA.launches == before + 1
    want = FA.flash_attention_plain(q, k, v, causal=False)
    torch.testing.assert_close(got.float(), want.float(), **FLASH_TOL[dtype])
    causal = FA.flash_attention_plain(q, k, v, causal=True)
    assert float((causal.float() - want.float()).abs().max()) > 0.1


# the default init's decay, exp(-exp(0.18)): the clamps bind from step 57
# of a chunk of 64, and for chunks longer than 73 A_excl is subnormal
CLAMPED_W = 0.30203348


def _wkv_inputs(B, T, H, P, regime, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    r, k, v = (torch.randn((B, T, H * P), generator=g) for _ in range(3))
    if regime == "clamped":
        w = torch.full((B, T, H * P), CLAMPED_W)
    else:
        w = torch.rand((B, T, H * P), generator=g) * 0.149 + 0.85
    u = torch.randn((H, P), generator=g) * 0.1
    return [t.to(device) for t in (r, k, v, w, u)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,P,Lc,regime", [
    (4, 1024, 64, 64, 64, "clamped"),
    (4, 1024, 8, 64, 64, "real"),
    (1, 100, 4, 64, 100, "clamped"),
    (1, 910, 4, 64, 65, "clamped"),
    (1, 127, 2, 64, 127, "clamped"),
    (2, 256, 4, 16, 64, "real"),
    (1, 256, 2, 32, 128, "real"),
])
def test_wkv_kernel_equals_plain(card, exact_f32, B, T, H, P, Lc, regime):
    """y and the final state against the plain version in float32 (both
    sum the same float32 terms in another order): 1e-4."""
    inp = _wkv_inputs(B, T, H, P, regime, card, seed=T + P)
    before = WKV.launches
    y, state = WKV.wkv(*inp, H, Lc)
    torch.cuda.synchronize()
    assert WKV.launches == before + 1
    wy, wstate = WKV.wkv_plain(*inp, H, Lc)
    assert y.dtype == state.dtype == torch.float32
    torch.testing.assert_close(y, wy, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(state, wstate, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_wkv_kernel_is_the_same_from_call_to_call(card):
    """The chunks' blocks pass the state along a chain of flags in whatever
    order they start: repeated calls give the same bits."""
    inp = _wkv_inputs(2, 1024, 16, 64, "real", card, seed=9)
    y, state = WKV.wkv(*inp, 16, 64)
    for _ in range(3):
        y2, state2 = WKV.wkv(*inp, 16, 64)
        assert torch.equal(y, y2) and torch.equal(state, state2)


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["P", "P_odd", "chunk", "dtype",
                                 "contiguous", "device", "aligned"])
def test_wkv_wrapper_raises_on_bad_inputs(card, bad):
    r, k, v, w, u = _wkv_inputs(1, 128, 2, 16, "real", card)
    H, Lc = 2, 64
    if bad == "P":
        r, k, v, w, u = _wkv_inputs(1, 128, 1, 96, "real", card)
        H = 1
    elif bad == "P_odd":                  # 16-byte loads need P % 4 == 0
        r, k, v, w, u = _wkv_inputs(1, 128, 2, 18, "real", card)
    elif bad == "aligned":
        r = torch.empty(r.numel() + 1, device=card)[1:].view_as(r).copy_(r)
    elif bad == "chunk":
        r, k, v, w, u = _wkv_inputs(1, 256, 2, 16, "real", card)
        Lc = 256
    elif bad == "dtype":
        r = r.bfloat16()
    elif bad == "contiguous":
        r = torch.cat([r, r], dim=-1)[..., ::2]
    else:
        u = u.cpu()
    with pytest.raises(ValueError):
        WKV.wkv(r, k, v, w, u, H, Lc)


@pytest.mark.cuda
def test_wkv_cuda_tensor_never_takes_the_plain_version(card, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("plain version called for a CUDA tensor")

    inp = _wkv_inputs(1, 64, 2, 16, "clamped", card)
    monkeypatch.setattr(WKV, "wkv_plain", refuse)
    before = WKV.launches
    WKV.wkv(*inp, 2, 64)
    trwkv.wkv_chunked(*inp, 2)
    assert WKV.launches == before + 2


@pytest.mark.cuda
def test_small_rwkv_serve_run_goes_through_the_wkv_kernel(card):
    """One cohort's prefill launches the kernel once per layer; decode
    launches none."""
    cfg = get_smoke_config("rwkv6-7b")
    model = Model(cfg, device=card).init_params(
        torch.Generator(device=card).manual_seed(0))
    eng = ServeEngine(model, max_batch=4)
    rng = np.random.default_rng(0)
    for _ in range(4):
        eng.submit(rng.integers(0, cfg.vocab_size, int(rng.integers(5, 90))),
                   max_new_tokens=4)
    before = WKV.launches
    stats = eng.run()
    assert stats["finished"] == 4
    assert all(len(r.tokens) == 4 for r in eng.finished)
    assert WKV.launches - before == cfg.num_layers


# ---------------- the forecast slice and the recorder on the card ---------

def _diurnal_stream(n, s, windows, seed):
    rng = np.random.default_rng(seed)
    mean = rng.uniform(100, 600, (n, s))
    phase = rng.uniform(0, 2 * np.pi, (n, s))
    active = rng.uniform(size=(n, s)) < 0.8
    for k in range(windows):
        t = 30.0 + 40.0 * k
        qps = mean * (1 + 0.35 * np.sin(2 * np.pi * t / 2880.0 + phase)
                      + 0.03 * rng.standard_normal((n, s)))
        yield t, qps.astype(np.float32), active


def _forecast_view(t, qps, active, device):
    from repro_torch.cluster.view import ClusterView

    n, s = qps.shape
    hists = torch.zeros((n, s + 2, 200))
    hists[:, 0, 6] = 64.0
    return ClusterView(
        t=t, online_qps=torch.as_tensor(qps, device=device),
        on_active=torch.as_tensor(active, device=device),
        on_type=(torch.arange(n * s).reshape(n, s) % 4).int().to(device),
        off_pressure=torch.linspace(0, 10, n, device=device),
        cpu_sum=torch.full((n,), 32.0, device=device),
        slot_hists=hists.to(device),
        slot_uids=np.arange(n * (s + 2)).reshape(n, s + 2))


@pytest.mark.cuda
def test_forecaster_and_service_on_the_card_equal_the_cpu(card):
    from repro_torch.control import ForecastService, QPSForecaster

    cpu = torch.device("cpu")
    n, s = 64, 4
    fc = {d: QPSForecaster(n, s, device=d) for d in (card, cpu)}
    svc = {d: ForecastService(device=d) for d in (card, cpu)}
    for t, qps, active in _diurnal_stream(n, s, 90, seed=1):
        for d in (card, cpu):
            fc[d].update(t, qps, active)
            svc[d].observe(_forecast_view(t, qps, active, d))
    g, c = fc[card], fc[cpu]
    # the card's sin / cos differ from the CPU's by ulps; summed over 90
    # windows a moment whose terms cancel keeps that absolute error, so
    # each moment is held relative to its own scale
    for k in ("A", "b", "err"):
        want = getattr(c, k)
        torch.testing.assert_close(getattr(g, k).cpu(), want, rtol=1e-5,
                                   atol=1e-6 * float(want.abs().max()))
    assert torch.equal(g.count.cpu(), c.count)
    assert torch.equal(g.confidence(t + 240.0).cpu(), c.confidence(t + 240.0))
    pg = svc[card].project(_forecast_view(t, qps, active, card))
    pc = svc[cpu].project(_forecast_view(t, qps, active, cpu))
    assert pc.trusted.any()
    assert torch.equal(pg.trusted.cpu(), pc.trusted)
    for k in ("runqlat", "rho", "delta"):
        torch.testing.assert_close(getattr(pg, k).cpu(), getattr(pc, k),
                                   rtol=1e-4, atol=1e-3)
    assert svc[card].forecaster.A.device.type == "cuda"


@pytest.mark.cuda
def test_icof_topk_scores_on_the_card_equal_the_cpu(card):
    from repro_torch.cluster.view import ClusterView
    from repro_torch.core import (
        ICOFScheduler,
        InterferenceQuantifier,
        SchedulerConfig,
    )

    n = 300
    g = torch.Generator().manual_seed(4)
    hists = torch.zeros((n, 2, 200))
    hists[torch.arange(n), 0, torch.randint(5, 60, (n,), generator=g)] = 50
    fields = dict(
        cpu_cur=torch.rand(n, generator=g) * 20, cpu_sum=torch.full((n,), 32.0),
        mem_cur=torch.rand(n, generator=g) * 40, mem_sum=torch.full((n,), 64.0),
        online_hists=hists, offline_hists=torch.zeros((n, 2, 200)),
        features=torch.rand((n, 45), generator=g) * 300,
        forecast_trusted=torch.rand(n, generator=g) < 0.6)
    views = {}
    for d in (card, torch.device("cpu")):
        v = ClusterView(**{k: x.to(d) for k, x in fields.items()})
        v.forecast_runqlat = (v.node_runqlat_avg().double()
                              + (torch.rand(n, generator=g.manual_seed(9))
                                 * 400).double().to(d))
        views[d.type] = v
    sched = ICOFScheduler(InterferenceQuantifier(lambda X: X[:, 21]),
                          SchedulerConfig(candidate_k=64), w_f=2.0)
    pod = Pod("web_search", 250.0, True)
    pod.cpu_demand, pod.mem_demand = 3.0, 4.0
    got = sched.scores(pod, views["cuda"]).cpu()
    want = sched.scores(pod, views["cpu"])
    assert torch.equal(torch.isfinite(got), torch.isfinite(want))
    fin = torch.isfinite(want)
    assert int(fin.sum()) == 64
    torch.testing.assert_close(got[fin], want[fin], rtol=1e-5, atol=1e-6)
    assert (sched.select_node(pod, views["cuda"])
            == sched.select_node(pod, views["cpu"]))


@pytest.mark.cuda
def test_recorder_off_run_equals_no_recorder_run_on_the_card(card):
    from repro_torch.cluster.experiment import bursty_trace, run_experiment
    from repro_torch.control import ControlLoop, ControlLoopConfig
    from repro_torch.core import ICOScheduler, InterferenceQuantifier
    from repro_torch.obs import NULL_RECORDER, TraceRecorder

    pods, gaps = bursty_trace(num_online=8, num_bursts=2, jobs_per_burst=3,
                              seed=5, burst_gap=(20, 30),
                              job_duration=(60, 100))

    def run(recorder):
        q = InterferenceQuantifier(
            lambda X: torch.full((X.shape[0],), 0.1, device=X.device))
        return run_experiment(
            ICOScheduler(q), pods, gaps, num_nodes=5, seed=5,
            control_loop=ControlLoop(q, ControlLoopConfig(proactive=True)),
            control_window=20, recorder=recorder, device=card)

    off = run(None)
    rec = TraceRecorder()
    assert run(rec) == off
    assert run(NULL_RECORDER) == off
    assert len(rec.events) > 0


@pytest.mark.cuda
def test_latency_sweep_on_the_card(card):
    """``bench_torch_scheduler_latency``'s sweep at 128 and 1,000 nodes on
    the card: a finite, positive mean and p99 for every scheduler, and each
    view's nodes selected as on the CPU."""
    import importlib.util
    import pathlib

    path = (pathlib.Path(__file__).resolve().parents[1] / "benchmarks"
            / "bench_torch_scheduler_latency.py")
    spec = importlib.util.spec_from_file_location("_bench_latency", path)
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    out: list = []
    res = bench.sweep((128, 1000), 5, device=card, out=out)
    assert len(out) == 10
    for name, by_n in res.items():
        for n, v in by_n.items():
            assert np.isfinite([v["mean_us"], v["p99_us"]]).all(), (name, n)
            assert 0 < v["mean_us"] <= v["p99_us"] * (1 + 1e-9), (name, n)
    cpu = bench.sweep((128, 1000), 5, device=torch.device("cpu"))
    for name in ("ICO", "ICO-F", "HUP", "LQP"):
        for n in ("128", "1000"):
            assert res[name][n]["selected"] == cpu[name][n]["selected"], (
                name, n)


# The backward kernel against its plain version.  Both sum the same
# float32 products in another order (the plain version in full float32, TF32
# off): float32 within 1e-4 of each result's largest value (dq, dk, dv are
# sums over up to S keys or S G queries); bf16 results are the same float32
# values rounded, so a bf16 ulp (2^-8) of the largest value at most.
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


def _bwd_inputs(B, S, H, KV, hd, dtype, device, causal, window, seed=0,
                kernel_fwd=True):
    """q, k, v, out, dout and lse: out and lse from the forward kernel (or,
    for a width it does not take, the plain version)."""
    q, k, v = _qkv(B, S, H, KV, hd, dtype, device, seed=seed)
    fwd = FA.flash_attention if kernel_fwd else FA.flash_attention_plain
    out, lse = fwd(q, k, v, causal=causal, sliding_window=window,
                   return_lse=True)
    g = torch.Generator().manual_seed(seed + 1)
    dout = torch.randn((B, S, H, hd), generator=g).to(dtype).to(device)
    return q, k, v, out.contiguous(), dout, lse


def _rel_err(got, want):
    return float((got.float() - want.float()).abs().max() /
                 want.float().abs().max().clamp_min(1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("H,KV", [(9, 3), (4, 4)])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0),
                                           (True, 100)])
@pytest.mark.parametrize("S", [300, 77, 5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [8, 16, 64, 80, 128, 256])
def test_flash_bwd_kernel_equals_plain(card, exact_f32, hd, dtype, S, causal,
                                       window, H, KV):
    """dq, dk, dv of the backward kernel (bf16 the wgmma one, float32 the
    3xTF32 one, from the forward kernel's out and lse) against
    ``flash_attention_bwd_plain`` at every width, both dtypes, GQA 3 and
    none, ragged S, causal, non-causal and windowed: three launches a call,
    counted, on the routed library.  (At S 1 the true dq and dk are 0, one
    key taking all the weight, and both versions give rounding noise, so
    the shortest S is 5.)"""
    q, k, v, out, dout, lse = _bwd_inputs(1 + (S < 100), S, H, KV, hd,
                                          dtype, card, causal, window,
                                          seed=S + hd)
    lib = FA.bwd_route(dtype, hd)[0]
    assert lib == {torch.bfloat16: "flash_attention_bwd_sm90",
                   torch.float32: "flash_attention_bwd_f32_sm90"}[dtype]
    before = FA.bwd_launches, FA.bwd_kernel_launches[lib]
    got = FA.flash_attention_bwd(q, k, v, out, dout, lse, causal=causal,
                                 sliding_window=window)
    torch.cuda.synchronize()
    assert (FA.bwd_launches, FA.bwd_kernel_launches[lib]) == tuple(
        n + FA.BWD_LAUNCHES_PER_CALL for n in before)
    want = FA.flash_attention_bwd_plain(q, k, v, out, dout, causal=causal,
                                        sliding_window=window)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype and a.shape == b.shape, name
        assert _rel_err(a, b) <= BWD_TOL[dtype], (name, _rel_err(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_kernel_is_deterministic(card, dtype):
    """No atomics: two launches on the same inputs give the same bits."""
    q, k, v, out, dout, lse = _bwd_inputs(2, 1000, 9, 3, 64, dtype, card,
                                          True, 0)
    a = FA.flash_attention_bwd(q, k, v, out, dout, lse)
    b = FA.flash_attention_bwd(q, k, v, out, dout, lse)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_flash_bwd_refuses_other_widths(card):
    q, k, v, out, dout, lse = _bwd_inputs(1, 64, 2, 2, 32, torch.float32,
                                          card, True, 0, kernel_fwd=False)
    with pytest.raises(ValueError, match="hd"):
        FA.flash_attention_bwd(q, k, v, out, dout, lse)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1024, 300])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,KV,hd", [(64, 4, 64), (48, 8, 128),
                                     (64, 8, 128)])
def test_flash_bwd_kernel_at_the_moe_and_vlm_groups(card, exact_f32, H, KV,
                                                    hd, dtype, S):
    """The attention of the MoE and qwen2-vl training families at their
    heads and widths (qwen3-moe 64 over 4, GQA group 16, hd 64;
    dbrx 48 over 8, group 6, hd 128; qwen2-vl 64 over 8, group 8, hd 128),
    causal, at a whole and a ragged S: dq, dk, dv within BWD_TOL of the
    plain backward, three launches on the routed library, and a second
    call bit-equal (no atomics in the sum over a group's heads)."""
    q, k, v, out, dout, lse = _bwd_inputs(2, S, H, KV, hd, dtype, card,
                                          True, 0, seed=H + KV + hd)
    lib = FA.bwd_route(dtype, hd)[0]
    before = FA.bwd_kernel_launches[lib]
    got = FA.flash_attention_bwd(q, k, v, out, dout, lse)
    again = FA.flash_attention_bwd(q, k, v, out, dout, lse)
    torch.cuda.synchronize()
    assert FA.bwd_kernel_launches[lib] == before + 2 * \
        FA.BWD_LAUNCHES_PER_CALL
    want = FA.flash_attention_bwd_plain(q, k, v, out, dout)
    for name, a, b, c in zip(("dq", "dk", "dv"), got, want, again):
        assert a.dtype == dtype and a.shape == b.shape, name
        assert _rel_err(a, b) <= BWD_TOL[dtype], (name, _rel_err(a, b))
        assert torch.equal(a, c), name


# the forward kernels' log-sum-exp against the plain version's: float32
# logs of the same sums in another order, over scores whose own error is
# ~1e-6 of their size (bf16 inputs' products in float32, or 3xTF32)
LSE_TOL = dict(rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0),
                                           (True, 100)])
@pytest.mark.parametrize("S", [300, 77, 5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [8, 16, 64, 80, 128, 256])
def test_flash_forward_lse_equals_plain(card, exact_f32, hd, dtype, S,
                                        causal, window):
    """The lse both forward kernels write when asked, (B, H, S) float32,
    against the plain version's ``m + log(max(l, 1e-30))``, GQA 9 over 3;
    and the output bit-equal to a call that asks for none (a null lse
    pointer)."""
    q, k, v = _qkv(2, S, 9, 3, hd, dtype, card, seed=S + hd)
    kw = dict(causal=causal, sliding_window=window)
    before = FA.launches
    out, lse = FA.flash_attention(q, k, v, return_lse=True, **kw)
    bare = FA.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert FA.launches == before + 2
    assert lse.shape == (2, 9, S) and lse.dtype == torch.float32
    _, want = FA.flash_attention_plain(q, k, v, return_lse=True, **kw)
    torch.testing.assert_close(lse, want, **LSE_TOL)
    assert torch.equal(out, bare)


@pytest.mark.cuda
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0),
                                           (True, 100)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [8, 64, 80, 256])
def test_flash_simt_bwd_kernel_equals_plain(card, exact_f32, hd, dtype,
                                            causal, window):
    """The SIMT backward kernel (``csrc/flash_attention_bwd.cu``, on no
    route since the tensor-core kernels replaced it) called through its own
    entry, as ``chip_smoke.py`` times it, still equals the plain version;
    it counts no launch."""
    q, k, v, out, dout, _ = _bwd_inputs(2, 300, 9, 3, hd, dtype, card,
                                        causal, window, seed=hd)
    fn = getattr(build.load(FA.BWD_SIMT[0]), FA.BWD_SIMT[1])
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    got = [torch.empty_like(t) for t in (q, k, v)]
    ws = torch.empty(3 * 2 * 9 * 300, dtype=torch.float32, device=card)
    dev, stream = build.device_and_stream(q)
    before = FA.bwd_launches
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             dout.data_ptr(), *(t.data_ptr() for t in got), ws.data_ptr(), 2,
             300, 9, 3, hd, int(causal), window, FA._DTYPES[dtype], dev,
             stream)
    torch.cuda.synchronize()
    assert err == 0 and FA.bwd_launches == before
    want = FA.flash_attention_bwd_plain(q, k, v, out, dout, causal=causal,
                                        sliding_window=window)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert _rel_err(a, b) <= BWD_TOL[dtype], (name, _rel_err(a, b))


@pytest.mark.cuda
def test_flash_bwd_raises_and_never_falls_back(card, monkeypatch):
    """A library that cannot load raises; the plain version is never
    taken for a CUDA tensor."""
    def refuse(*a, **k):
        raise AssertionError("plain version called for a CUDA tensor")

    def no_lib(name, *a, **k):
        raise RuntimeError(f"cannot load {name}")

    q, k, v, out, dout, lse = _bwd_inputs(1, 64, 2, 2, 64, torch.float32,
                                          card, True, 0)
    monkeypatch.setattr(FA, "flash_attention_bwd_plain", refuse)
    monkeypatch.setattr(build, "load", no_lib)
    with pytest.raises(RuntimeError, match="cannot load"):
        FA.flash_attention_bwd(q, k, v, out, dout, lse)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_autograd_function_on_the_card(card, exact_f32, dtype):
    """``FlashAttention.apply``'s gradients (the forward and backward
    kernels) against autograd over the plain forward, at smollm-135m's
    heads (9 over 3, hd 64)."""
    q, k, v = (t.requires_grad_() for t in _qkv(2, 256, 9, 3, 64, dtype,
                                                card, seed=3))
    g = torch.Generator().manual_seed(5)
    dout = torch.randn((2, 256, 9, 64), generator=g).to(dtype).to(card)
    fwd, bwd = FA.launches, FA.bwd_launches
    got = torch.autograd.grad(FA.FlashAttention.apply(q, k, v, True, 0),
                              (q, k, v), dout)
    assert FA.launches == fwd + 1
    assert FA.bwd_launches == bwd + FA.BWD_LAUNCHES_PER_CALL
    want = torch.autograd.grad(FA.flash_attention_plain(q, k, v), (q, k, v),
                               dout)
    for a, b in zip(got, want):
        assert _rel_err(a, b) <= BWD_TOL[dtype]


@pytest.mark.cuda
def test_smoke_training_step_goes_through_both_flash_kernels(card):
    """One ``make_train_step`` step of the smollm smoke model on the card
    (hd 16, bf16; remat, accum 2, compression): two forward launches a
    layer a microbatch (remat recomputes), one backward call (three
    launches) a layer a microbatch, and finite metrics."""
    from repro_torch.data import SyntheticLM
    from repro_torch.train import init_train_state, make_train_step

    cfg = get_smoke_config("smollm-135m")
    model, opt = init_train_state(Model(cfg, device=card),
                                  torch.Generator(device=card).manual_seed(0),
                                  compress=True)
    step = make_train_step(model, accum=2, compress=True)
    batch = SyntheticLM(cfg.vocab_size, 100, 4, seed=0).batch(0)
    fwd, bwd = FA.launches, FA.bwd_launches
    opt, m = step(opt, batch)
    torch.cuda.synchronize()
    assert FA.launches - fwd == cfg.num_layers * 2 * 2
    assert FA.bwd_launches - bwd == (cfg.num_layers * 2
                                     * FA.BWD_LAUNCHES_PER_CALL)
    assert np.isfinite(float(m["loss"])) and np.isfinite(
        float(m["grad_norm"]))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["smollm-135m", "gemma3-4b",
                                  "hubert-xlarge", "qwen3-moe-235b-a22b",
                                  "dbrx-132b", "qwen2-vl-72b"])
def test_training_gradients_kernel_path_equal_plain(card, exact_f32, arch):
    """Float32 smoke models on the card (causal, windowed at T 100 past
    gemma3's window of 32, non-causal, the two MoE, qwen2-vl at image-grid
    M-RoPE positions so that its three streams differ): every gradient
    leaf through the kernels within 1e-4 of its largest value of the plain
    path's.  The MoE's plain run takes the kernel run's routing, layer by
    layer through remat's recomputes (``PinnedRouting``)."""
    import dataclasses

    from repro_torch.models import model as TM
    from repro_torch.models.routing import PinnedRouting

    cfg = dataclasses.replace(get_smoke_config(arch), dtype=torch.float32)
    model = Model(cfg, device=card).init_params(
        torch.Generator(device=card).manual_seed(0))
    model.requires_grad_(True)
    g = torch.Generator().manual_seed(1)
    batch = {"labels": torch.randint(0, cfg.vocab_size, (2, 100),
                                     generator=g).to(card)}
    if cfg.embed_inputs:
        batch["embeds"] = torch.randn((2, 100, cfg.d_model),
                                      generator=g).to(card)
    else:
        batch["tokens"] = torch.randint(0, cfg.vocab_size, (2, 100),
                                        generator=g).to(card)
    if cfg.mrope_sections:
        batch["positions"] = _grid_positions(2, 100, 8).to(card)
    params = list(model.parameters())
    grads = {}
    with PinnedRouting() as pin:
        for use in (True, False):
            model.cfg = dataclasses.replace(cfg, use_kernels=use)
            bwd = FA.bwd_launches
            loss, _ = TM.train_loss(model, batch)
            grads[use] = torch.autograd.grad(loss, params)
            assert (FA.bwd_launches - bwd > 0) == use
            pin.replay()
    # the kernel run's recomputes, the plain run's forwards and recomputes
    assert pin.tokens == (3 * cfg.num_layers * 200 if cfg.num_experts
                          else 0)
    for a, b in zip(grads[True], grads[False]):
        assert _rel_err(a, b) <= BWD_TOL[torch.float32]


# ---------------------------------------------- the scans' backward kernels

def _scan_grads_close(got, want, dtype, names):
    """Each gradient's max abs error within BWD_TOL of its largest value:
    float32, the same float32 terms in another order; bf16 outputs, a bf16
    ulp of a value near the largest."""
    for name, a, b in zip(names, got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert torch.isfinite(a).all(), name
        assert _rel_err(a, b) <= BWD_TOL[dtype], (name, _rel_err(a, b))


SSD_GRADS = ("dx", "ddt", "dA", "dB", "dC")


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,P,N,dtype,with_state", [
    (4, 1024, 64, 64, 64, torch.bfloat16, False),   # zamba2-1.2b's microbatch
    (4, 1024, 64, 64, 64, torch.float32, True),
    (2, 1000, 4, 64, 64, torch.bfloat16, True),     # a ragged last chunk
    (2, 37, 3, 16, 16, torch.float32, False),       # one short chunk
    (2, 200, 8, 16, 16, torch.bfloat16, True),      # the smoke width
    (1, 130, 2, 48, 32, torch.float32, True),
    (2, 65, 5, 24, 40, torch.float32, False),       # P, N off the 16 grid
    (8, 1024, 20, 64, 64, torch.bfloat16, False),   # 8 heads a block on 132
                                                    # SMs, the last group 4
])
def test_ssd_bwd_kernel_equals_plain(card, exact_f32, B, T, H, P, N, dtype,
                                     with_state):
    """Every gradient of the SSD backward kernel against ``ssd_bwd_plain``
    on the same inputs (A in [-16, -1], as the model's init, where JAX's
    own gradient is NaN): 1e-4 of each gradient's largest value in float32,
    1e-2 in bf16; four launches a call."""
    inp = _ssd_inputs(B, T, H, P, N, dtype, card, seed=T + P,
                      a_range=(1.0, 16.0))
    g = torch.Generator(device=card).manual_seed(T)
    dy = torch.randn(inp[0].shape, generator=g, device=card).to(dtype)
    ds = (torch.randn((B, H, P, N), generator=g, device=card)
          if with_state else None)
    before = SSD.bwd_launches
    got = SSD.ssd_bwd(*inp, dy, ds)
    torch.cuda.synchronize()
    assert SSD.bwd_launches == before + SSD.BWD_LAUNCHES_PER_CALL
    _scan_grads_close(got, SSD.ssd_bwd_plain(*inp, dy, ds), dtype, SSD_GRADS)


@pytest.mark.cuda
@pytest.mark.parametrize("heads,B,T,H,P,N,dtype,with_state", [
    (2, 2, 300, 5, 64, 64, torch.bfloat16, True),    # groups of 2, 2, 1
    (3, 1, 200, 8, 32, 48, torch.float32, False),    # 3, 3, 2
    (4, 2, 1024, 62, 64, 64, torch.float32, True),   # fifteen of 4, one of 2
    (4, 1, 1000, 6, 64, 64, torch.bfloat16, True),   # 4, 2; a ragged chunk
    (8, 1, 130, 12, 64, 64, torch.bfloat16, False),  # 8, 4
    (8, 2, 100, 8, 24, 40, torch.float32, True),     # one whole group
])
def test_ssd_bwd_kernel_groups_of_heads(card, exact_f32, monkeypatch, heads,
                                        B, T, H, P, N, dtype, with_state):
    """The backward kernel at ``heads`` heads a block, whatever the card's
    multiprocessors would choose, the last group short where H is not a
    multiple of it (C B^T shared, dB and dC summed over a group's heads):
    every gradient against ``ssd_bwd_plain`` at the tolerances above."""
    chosen = []

    def fixed(Bsz, nc, H_, sms):
        chosen.append(heads)
        return heads

    monkeypatch.setattr(SSD, "_bwd_heads", fixed)
    inp = _ssd_inputs(B, T, H, P, N, dtype, card, seed=T + H,
                      a_range=(1.0, 16.0))
    g = torch.Generator(device=card).manual_seed(H)
    dy = torch.randn(inp[0].shape, generator=g, device=card).to(dtype)
    ds = (torch.randn((B, H, P, N), generator=g, device=card)
          if with_state else None)
    got = SSD.ssd_bwd(*inp, dy, ds)
    torch.cuda.synchronize()
    assert chosen == [heads]
    _scan_grads_close(got, SSD.ssd_bwd_plain(*inp, dy, ds), dtype, SSD_GRADS)


@pytest.mark.cuda
def test_ssd_bwd_kernel_is_deterministic(card):
    """No atomics, fixed orders of summation: two calls, the same bits."""
    inp = _ssd_inputs(2, 1000, 8, 64, 64, torch.bfloat16, card, seed=5,
                      a_range=(1.0, 16.0))
    dy = torch.randn(inp[0].shape, device=card).bfloat16()
    first = SSD.ssd_bwd(*inp, dy)
    again = SSD.ssd_bwd(*inp, dy)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.cuda
def test_ssd_scan_backward_launches_the_kernel(card, monkeypatch):
    """``SSDScan`` on CUDA tensors: the forward and backward kernels, never
    a plain version; the dropped final state's gradient arrives as None."""
    def refuse(*a, **k):
        raise AssertionError("plain version called for a CUDA tensor")

    monkeypatch.setattr(SSD, "ssd_plain", refuse)
    monkeypatch.setattr(SSD, "ssd_bwd_plain", refuse)
    inp = [t.requires_grad_() for t in _ssd_inputs(
        2, 100, 4, 32, 16, torch.bfloat16, card, seed=1)]
    fwd, bwd = SSD.launches, SSD.bwd_launches
    y, _ = SSD.SSDScan.apply(*inp)
    y.float().sum().backward()
    torch.cuda.synchronize()
    assert (SSD.launches - fwd, SSD.bwd_launches - bwd) == (
        1, SSD.BWD_LAUNCHES_PER_CALL)
    assert all(t.grad is not None and torch.isfinite(t.grad).all()
               for t in inp)


WKV_GRADS = ("dr", "dk", "dv", "dw", "du")


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,P,Lc,regime,with_state", [
    (4, 1024, 64, 64, 64, "clamped", False),   # rwkv6-7b's microbatch
    (4, 1024, 64, 64, 64, "real", True),
    (2, 64, 4, 16, 64, "clamped", True),       # the smoke width, floors bind
    (2, 96, 3, 16, 32, "real", False),
    (1, 40, 2, 64, 40, "clamped", True),       # one chunk of 40
    (2, 128, 2, 12, 16, "real", True),
    (2, 100, 4, 64, 100, "clamped", False),    # chunks of 65-128 steps:
    (2, 160, 4, 64, 80, "real", True),         # two 64-row halves
    (1, 127, 2, 16, 127, "clamped", True),
])
def test_wkv_bwd_kernel_equals_plain(card, exact_f32, B, T, H, P, Lc, regime,
                                     with_state):
    """Every gradient of the WKV backward kernel against ``wkv_bwd_plain``
    on the same float32 inputs: 1e-4 of each gradient's largest value, at
    the default init's decay (the 1e-30 floor binds from step 57; past step
    ~64 A_excl leaves float32's normal range, in both versions) and at real
    decays, chunks of up to 128 steps; four launches a call."""
    inp = _wkv_inputs(B, T, H, P, regime, card, seed=T + P)
    g = torch.Generator(device=card).manual_seed(T)
    dy = torch.randn(inp[0].shape, generator=g, device=card)
    ds = (torch.randn((B, H, P, P), generator=g, device=card)
          if with_state else None)
    before = WKV.bwd_launches
    got = WKV.wkv_bwd(*inp, H, Lc, dy, ds)
    torch.cuda.synchronize()
    assert WKV.bwd_launches == before + WKV.BWD_LAUNCHES_PER_CALL
    _scan_grads_close(got, WKV.wkv_bwd_plain(*inp, H, Lc, dy, ds),
                      torch.float32, WKV_GRADS)


@pytest.mark.cuda
def test_wkv_bwd_kernel_is_deterministic_and_refuses_long_chunks(card):
    """No atomics, fixed orders of summation: two calls give the same
    bits, at chunks of 64 and of 100 (two halves); a chunk of 129 steps is
    refused before any launch."""
    for T, Lc in ((1024, 64), (1000, 100)):
        inp = _wkv_inputs(2, T, 16, 64, "real", card, seed=9)
        dy = torch.randn(inp[0].shape, device=card)
        first = WKV.wkv_bwd(*inp, 16, Lc, dy)
        again = WKV.wkv_bwd(*inp, 16, Lc, dy)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(first, again)), Lc
    inp = _wkv_inputs(1, 258, 2, 64, "real", card, seed=9)
    before = WKV.bwd_launches
    with pytest.raises(ValueError, match="chunks"):
        WKV.wkv_bwd(*inp, 2, 129, torch.randn(inp[0].shape, device=card))
    assert WKV.bwd_launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("arch,seq", [
    pytest.param("zamba2-1.2b", 128, id="zamba2-1.2b"),
    pytest.param("rwkv6-7b", 128, id="rwkv6-7b"),
    pytest.param("rwkv6-7b", 160, id="rwkv6-7b-seq160"),  # chunks of 80
])
def test_scan_models_train_on_the_card(card, exact_f32, arch, seq):
    """One ``make_train_step`` step of the smoke config (remat, accum 2,
    compression) on the card: each scan's forward kernel twice a layer a
    microbatch where remat recomputes it (once in zamba2's tail) and its
    backward kernel once, finite metrics; then a float32 copy's gradients
    with the scan swapped for a ``scan_function`` of each pair of
    directions: the backward kernel alone, the forward kernel alone and
    both kernels, each within 1e-4 of each leaf's largest value of the
    plain directions' (the plain forward and ``*_bwd_plain``: autograd
    through the float32 plain scan is NaN at this init)."""
    import dataclasses

    from repro_torch.data import SyntheticLM
    from repro_torch.models import model as TM
    from repro_torch.train import init_train_state, make_train_step
    from repro_torch.train.train_step import batch_to_device

    lib, fn_name = (SSD, "SSDScan") if arch == "zamba2-1.2b" else \
        (WKV, "WKVScan")
    cfg = get_smoke_config(arch)
    model, opt = init_train_state(Model(cfg, device=card),
                                  torch.Generator(device=card).manual_seed(0),
                                  compress=True)
    step = make_train_step(model, accum=2, compress=True)
    batch = SyntheticLM(cfg.vocab_size, seq, 4, seed=0).batch(0)
    fwd, bwd = lib.launches, lib.bwd_launches
    opt, m = step(opt, batch)
    torch.cuda.synchronize()
    scanned = len(cfg.pattern) * cfg.repeats       # under remat
    assert lib.launches - fwd == (cfg.num_layers + scanned) * 2
    assert lib.bwd_launches - bwd == (cfg.num_layers * 2
                                      * lib.BWD_LAUNCHES_PER_CALL)
    assert np.isfinite(float(m["loss"])) and np.isfinite(
        float(m["grad_norm"]))

    wide = Model(dataclasses.replace(cfg, dtype=torch.float32), device=card)
    with torch.no_grad():
        for (_, a), (_, b) in zip(wide.named_parameters(),
                                  model.named_parameters()):
            a.copy_(b)
    wide.requires_grad_(True)
    names = [n for n, _ in wide.named_parameters()]
    tb = batch_to_device(batch, card)
    real = getattr(lib, fn_name)
    fwds = {"kernel": lib.ssd if lib is SSD else lib.wkv,
            "plain": lib.ssd_plain if lib is SSD else lib.wkv_plain}
    bwds = {"kernel": lib.ssd_bwd if lib is SSD else lib.wkv_bwd,
            "plain": lib.ssd_bwd_plain if lib is SSD else lib.wkv_bwd_plain}
    grads = {}
    for how in (("kernel", "kernel"), ("plain", "kernel"), ("kernel", "plain"),
                ("plain", "plain")):
        setattr(lib, fn_name, scan_function(fn_name, fwds[how[0]],
                                            bwds[how[1]]))
        before = lib.bwd_launches
        try:
            loss, _ = TM.train_loss(wide, tb)
            grads[how] = torch.autograd.grad(loss, list(wide.parameters()))
        finally:
            setattr(lib, fn_name, real)
        assert (lib.bwd_launches > before) == (how[1] == "kernel")
    # each kernel alone and both together: float32 sums in another order
    plain = grads["plain", "plain"]
    for how in (("kernel", "kernel"), ("plain", "kernel"), ("kernel", "plain")):
        for name, a, c in zip(names, grads[how], plain):
            assert torch.isfinite(a).all(), (how, name)
            assert _rel_err(a, c) <= BWD_TOL[torch.float32], (
                how, name, _rel_err(a, c))


@pytest.mark.cuda
def test_wkv_chunked_refuses_long_chunks_before_the_forward(card, exact_f32):
    """Chunks of more than 64 steps, which JAX's rule gives at T 100 (one
    chunk of 100) and T 160 (two of 80), are no longer refused: under
    autograd ``wkv_chunked`` launches the forward kernel once and the
    backward kernel's launches once, and its gradients equal the plain
    directions' (``wkv_plain``, ``wkv_bwd_plain``) within 1e-4 of each
    one's largest value; without a gradient the forward kernel runs alone.
    The backward kernel's own refusal of chunks past 128 steps, which JAX's
    rule never gives, is in the test above."""
    plain = scan_function("WKVScan", WKV.wkv_plain, WKV.wkv_bwd_plain)
    for T in (100, 160):
        inp = _wkv_inputs(1, T, 2, 16, "real", card, seed=T)
        g = torch.Generator(device=card).manual_seed(T)
        dy = torch.randn(inp[0].shape, generator=g, device=card)
        ds = torch.randn((1, 2, 16, 16), generator=g, device=card)
        grads = {}
        for how in ("kernel", "plain"):
            leaves = [t.clone().requires_grad_() for t in inp]
            fwd, bwd = WKV.launches, WKV.bwd_launches
            if how == "kernel":
                y, s = trwkv.wkv_chunked(*leaves, 2)
            else:
                y, s = plain.apply(*leaves, 2, trwkv.chunk_len(T))
            ((y * dy).sum() + (s * ds).sum()).backward()
            torch.cuda.synchronize()
            counts = (WKV.launches - fwd, WKV.bwd_launches - bwd)
            assert counts == ((1, WKV.BWD_LAUNCHES_PER_CALL)
                              if how == "kernel" else (0, 0)), (T, counts)
            grads[how] = [t.grad for t in leaves]
        _scan_grads_close(grads["kernel"], grads["plain"], torch.float32,
                          WKV_GRADS)
        fwd = WKV.launches
        with torch.no_grad():
            y, _ = trwkv.wkv_chunked(*inp, 2)
        torch.cuda.synchronize()
        assert WKV.launches == fwd + 1 and torch.isfinite(y).all()
