"""The Mamba-2 SSD chunked scan: wrapper, plain version and launch count.

``ssd`` is the port of ``repro/kernels/ssd.py::ssd_pallas`` (body
``_ssd_kernel``): per (batch, head), a scalar decay ``exp(dt * A)`` per
step, a (P x N) float32 state carried across chunks of ``CHUNK`` steps,
and inside a chunk the lower-triangular decay matrix.  With a single B/C
group shared across heads:

    S_t = exp(dt_t A) S_{t-1} + dt_t x_t B_t^T,    y_t = S_t C_t

It returns ``y`` (like x) and the final state (B, H, P, N) float32, which
``ssd_pallas`` keeps in VMEM scratch and drops; the model's prefill needs
it for the decode cache, as JAX's ``models/ssd.py::ssd_chunked`` returns
it.  Two CUDA C++ kernels compute it (design and bound are noted in each):
bfloat16 x, B and C go to ``csrc/ssd_sm90.cu`` (the products on the tensor
cores, one block per (batch, chunk, pair of heads), the state passed from
chunk to chunk through the state output, which the wrapper zeroes, and a
zeroed (1 + B H,) int32 buffer for the kernel's ticket and its counts of
written chunks, allocated each call), float32 ones to
``csrc/ssd.cu`` (one block per (batch, head), products on the float32
CUDA cores).

``ssd_plain`` follows ``ssd_chunked``'s arithmetic and chunking: chunks of
``min(CHUNK, T)`` steps, a ragged T zero-padded to whole chunks (a padded
step has dt = 0, so it neither decays nor feeds the state).  For tensors
on the CPU the wrapper takes it; for CUDA tensors it launches the kernel
of their type or raises: there is no fallback, and no kernel is tried
after another.  ``launches`` counts launches of either kernel and nothing
else.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import build, plain_dtype, scan_function

CHUNK = 64
MAX_DIM = 64            # the kernels' bound on P and N
DIM_STEP = 16           # the bf16 kernel takes P and N in multiples of this
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0
bwd_launches = 0
BWD_LAUNCHES_PER_CALL = 4   # chunk states, the chain, the chunks, the sums
BWD_HEADS = 8               # heads a block of the backward kernel, at most


def _chunking(T: int):
    """(chunk length, chunks, padded steps): chunks of ``min(CHUNK, T)``,
    the last one zero-padded."""
    Lc = min(CHUNK, T)
    nc = -(-T // Lc)
    return Lc, nc, nc * Lc - T


def ssd_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
              B_: torch.Tensor, C: torch.Tensor):
    """x: (B,T,H,P), dt: (B,T,H) (>0), A: (H,) (<0), B_/C: (B,T,N).

    Returns (y (B,T,H,P) like x, final_state (B,H,P,N) float32; float64
    for float64 x, which the whole computation then keeps).
    """
    Bsz, T, H, P = x.shape
    N = B_.shape[-1]
    Lc, nc, pad = _chunking(T)
    ft = plain_dtype(x)

    def chunks(a, tail):  # (B, T, *tail) -> (B, nc, Lc, *tail) in ft
        a = F.pad(a.to(ft), (0, 0) * len(tail) + (0, pad))
        return a.reshape(Bsz, nc, Lc, *tail)

    xf = chunks(x, (H, P)).permute(1, 0, 3, 2, 4)          # (nc,B,H,Lc,P)
    dtf = chunks(dt, (H,)).permute(1, 0, 3, 2)             # (nc,B,H,Lc)
    Bf = chunks(B_, (N,)).permute(1, 0, 2, 3)              # (nc,B,Lc,N)
    Cf = chunks(C, (N,)).permute(1, 0, 2, 3)
    loga = dtf * A.to(ft)[None, None, :, None]             # <= 0
    cum = torch.cumsum(loga, dim=-1)                       # inclusive
    tot = torch.exp(cum[..., -1:])                         # (nc,B,H,1)
    tmask = torch.tril(torch.ones((Lc, Lc), dtype=torch.bool,
                                  device=x.device))
    S = torch.zeros((Bsz, H, P, N), dtype=ft, device=x.device)
    ys = []
    for c in range(nc):
        xc, dtc, Bc, Cc, cumc = xf[c], dtf[c], Bf[c], Cf[c], cum[c]
        # inter-chunk: y[t] = exp(cum[t]) * S_0 C_t
        SC = torch.einsum("bhpn,btn->bhtp", S, Cc)
        y_inter = torch.exp(cumc)[..., None] * SC
        # intra-chunk: decay(t, s) = exp(cum[t] - cum[s]) for s <= t
        dmat = torch.exp(cumc[..., :, None] - cumc[..., None, :])
        dmat = torch.where(tmask, dmat, 0.0)               # (b,h,t,s)
        bc = torch.einsum("btn,bsn->bts", Cc, Bc)
        w = dmat * bc[:, None] * dtc[:, :, None, :]
        y_intra = torch.einsum("bhts,bhsp->bhtp", w, xc)
        # state: S' = tot * S + sum_s exp(cum[-1] - cum[s]) dt_s x_s B_s^T
        decay_s = torch.exp(cumc[..., -1:] - cumc) * dtc
        xw = xc * decay_s[..., None]
        S = S * tot[c][..., None] + torch.einsum("bhsp,bsn->bhpn", xw, Bc)
        ys.append(y_inter + y_intra)
    y = torch.stack(ys).permute(1, 0, 3, 2, 4).reshape(Bsz, nc * Lc, H, P)
    return y[:, :T].to(x.dtype), S


def _check(x, dt, A, B_, C) -> None:
    if x.dim() != 4:
        raise ValueError(f"x must be (B, T, H, P), got {tuple(x.shape)}")
    Bsz, T, H, P = x.shape
    if dt.shape != (Bsz, T, H) or A.shape != (H,):
        raise ValueError(f"dt {tuple(dt.shape)} / A {tuple(A.shape)} do not "
                         f"match x {tuple(x.shape)}")
    if B_.dim() != 3 or B_.shape[:2] != (Bsz, T) or C.shape != B_.shape:
        raise ValueError(f"B/C must be (B, T, N), got {tuple(B_.shape)}, "
                         f"{tuple(C.shape)}")
    if len({t.device for t in (x, dt, A, B_, C)}) != 1:
        raise ValueError("ssd: every input must lie on one device")


# bf16 takes the tensor-core kernel, float32 the SIMT one (its products in
# full float32, which TF32 tensor cores would not keep)
_ENTRIES = {torch.bfloat16: ("ssd_sm90", "ssd_sm90_launch"),
            torch.float32: ("ssd", "ssd_launch")}


def _entry(dtype):
    lib, name = _ENTRIES[dtype]
    fn = getattr(build.load(lib), name)
    if fn.argtypes is None:  # pointers and the stream as c_void_p, not int
        if dtype == torch.bfloat16:   # + the sync buffer, no dtype code
            fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [
                ctypes.c_void_p]
        else:
            fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [
                ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _launch(x, dt, A, B_, C):
    global launches
    Bsz, T, H, P = x.shape
    N = B_.shape[-1]
    if x.dtype not in _DTYPES or B_.dtype != x.dtype or C.dtype != x.dtype:
        raise ValueError(f"ssd kernel: x, B, C must share float32 or "
                         f"bfloat16, got {x.dtype}, {B_.dtype}, {C.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise ValueError(f"ssd kernel: dt and A must be float32, got "
                         f"{dt.dtype}, {A.dtype}")
    if not (0 < P <= MAX_DIM and 0 < N <= MAX_DIM):
        raise ValueError(f"ssd kernel takes P, N <= {MAX_DIM}, got P={P}, "
                         f"N={N}")
    sm90 = x.dtype == torch.bfloat16
    if sm90 and (P % DIM_STEP or N % DIM_STEP):
        raise ValueError(f"ssd bf16 kernel takes P, N in multiples of "
                         f"{DIM_STEP}, got P={P}, N={N}")
    for name, t in (("x", x), ("dt", dt), ("A", A), ("B", B_), ("C", C)):
        if not t.is_contiguous():
            raise ValueError(f"ssd: {name} must be contiguous")
    if sm90 and any(t.data_ptr() % 16 for t in (x, B_, C)):
        raise ValueError("ssd bf16 kernel: x, B and C must be 16-byte "
                         "aligned (it loads them in 16-byte pieces)")
    if x.numel() >= 2**31:
        raise ValueError("ssd: too large for 32-bit indexing")
    fn = _entry(x.dtype)
    y = torch.empty_like(x)
    # the bf16 kernel passes the state from chunk to chunk through this
    # buffer, and reads a zero as "not yet written"
    state = (torch.zeros if sm90 else torch.empty)(
        (Bsz, H, P, N), dtype=torch.float32, device=x.device)
    if x.numel() == 0:
        return y, state.zero_()
    dev, stream = build.device_and_stream(x)
    ptrs = [x.data_ptr(), dt.data_ptr(), A.data_ptr(), B_.data_ptr(),
            C.data_ptr(), y.data_ptr(), state.data_ptr()]
    if sm90:   # its ticket, then room for a count a (batch, head)
        sync = torch.zeros(1 + Bsz * H, dtype=torch.int32, device=x.device)
        err = fn(*ptrs, sync.data_ptr(), Bsz, T, H, P, N, dev, stream)
    else:
        err = fn(*ptrs, Bsz, T, H, P, N, _DTYPES[x.dtype], dev, stream)
    if err != 0:
        raise RuntimeError(f"ssd launch failed: CUDA error {err}")
    launches += 1
    return y, state


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B_: torch.Tensor,
        C: torch.Tensor):
    """x: (B,T,H,P), dt: (B,T,H), A: (H,), B_/C: (B,T,N) ->
    (y like x, final_state (B,H,P,N) float32)."""
    _check(x, dt, A, B_, C)
    if x.device.type == "cpu":
        return ssd_plain(x, dt, A, B_, C)
    if x.device.type != "cuda":
        raise ValueError(f"ssd: unsupported device {x.device}")
    return _launch(x, dt, A, B_, C)


# ------------------------------------------------------------- backward --

def ssd_bwd_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  B_: torch.Tensor, C: torch.Tensor, dy: torch.Tensor,
                  dstate: torch.Tensor | None = None):
    """The VJP of ``ssd_plain``, written out by hand: for the output
    gradient ``dy`` (like x) and the final state's ``dstate`` (B,H,P,N;
    None is zero) returns (dx like x, ddt like dt, dA like A, dB like B_,
    dC like C).

    Per chunk, with loga = dt A, cum its inclusive sum, E[t, s] = exp(cum_t
    - cum_s) for s <= t, S0 the state at the chunk's start and dS1 the
    gradient of the state at its end (both from a pass over the chunks):

        dx_s  = sum_t E dt_s (C_t.B_s) dy_t + e_s dt_s dS1 B_s
        dC_t  = exp(cum_t) S0^T dy_t + sum_s E dt_s (dy_t.x_s) B_s
        dB_s  = sum_t E dt_s (dy_t.x_s) C_t + e_s dt_s dS1^T x_s
        dS0   = exp(cum_end) dS1 + sum_t exp(cum_t) dy_t C_t^T

    with e_s = exp(cum_end - cum_s), and dt's gradient through the terms
    that hold dt_s directly and through cum (a reverse cumulative sum of
    cum's gradient, times A; A's is that times dt, summed).  Unlike
    autograd through ``ssd_plain``, which takes exp of the positive cum_t
    - cum_s above the diagonal before masking it (inf where the decay is
    fast, and then 0 * inf = NaN in the gradient, as in JAX), the exponent
    above the diagonal is set to -inf first, so no pair s > t is formed.
    float64 inputs are computed in float64, all others in float32.
    """
    Bsz, T, H, P = x.shape
    N = B_.shape[-1]
    Lc, nc, pad = _chunking(T)
    ft = plain_dtype(x)

    def chunks(a, tail):  # (B, T, *tail) -> (B, nc, Lc, *tail) in ft
        a = F.pad(a.to(ft), (0, 0) * len(tail) + (0, pad))
        return a.reshape(Bsz, nc, Lc, *tail)

    xc, dyc = chunks(x, (H, P)), chunks(dy, (H, P))        # (b,c,t,h,p)
    dtc = chunks(dt, (H,))                                 # (b,c,t,h)
    Bc, Cc = chunks(B_, (N,)), chunks(C, (N,))             # (b,c,t,n)
    a = A.to(ft)
    cum = torch.cumsum(dtc * a, dim=2)
    dec = torch.exp(cum)                                   # exp(cum_t)
    tot = dec[:, :, -1]                                    # (b,c,h)
    ex_end = torch.exp(cum[:, :, -1:] - cum)               # e_s <= 1
    fac = ex_end * dtc
    tri = torch.tril(torch.ones((Lc, Lc), dtype=torch.bool,
                                device=x.device))[..., None]
    diff = cum[:, :, :, None] - cum[:, :, None, :]         # (b,c,t,s,h)
    E = torch.exp(torch.where(tri, diff, float("-inf")))

    # the chunk-start states S0 and the end-of-chunk state gradients dS1
    loc = torch.einsum("bcsh,bcshp,bcsn->bchpn", fac, xc, Bc)
    G = torch.einsum("bcth,bcthp,bctn->bchpn", dec, dyc, Cc)
    S = torch.zeros((Bsz, H, P, N), dtype=ft, device=x.device)
    starts = []
    for c in range(nc):
        starts.append(S)
        S = tot[:, c, :, None, None] * S + loc[:, c]
    dS = (torch.zeros_like(S) if dstate is None else dstate.to(ft))
    ends = [None] * nc
    for c in reversed(range(nc)):
        ends[c] = dS
        dS = tot[:, c, :, None, None] * dS + G[:, c]
    S0, dS1 = torch.stack(starts, 1), torch.stack(ends, 1)  # (b,c,h,p,n)

    CB = torch.einsum("bctn,bcsn->bcts", Cc, Bc)[..., None]
    dyx = torch.einsum("bcthp,bcshp->bctsh", dyc, xc)
    dt_s = dtc[:, :, None]                                 # (b,c,1,s,h)
    W = E * CB * dt_s
    R = E * dt_s * dyx
    Q = E * CB * dyx
    BdS = torch.einsum("bcsn,bchpn->bcshp", Bc, dS1)
    dx = (torch.einsum("bctsh,bcthp->bcshp", W, dyc)
          + fac[..., None] * BdS)
    dC = (torch.einsum("bcth,bcthp,bchpn->bctn", dec, dyc, S0)
          + torch.einsum("bctsh,bcsn->bctn", R, Bc))
    dB = (torch.einsum("bctsh,bctn->bcsn", R, Cc)
          + torch.einsum("bcsh,bcshp,bchpn->bcsn", fac, xc, dS1))
    xBdS = (xc * BdS).sum(-1)                              # (b,c,s,h)
    M = Q * dt_s
    inter = dec * torch.einsum("bcthp,bctn,bchpn->bcth", dyc, Cc, S0)
    dcum = inter + M.sum(3) - M.sum(2) - fac * xBdS
    dcum[:, :, -1] += ((fac * xBdS).sum(2)
                       + tot * (S0 * dS1).sum((-1, -2)))
    dloga = torch.flip(torch.cumsum(torch.flip(dcum, (2,)), 2), (2,))
    ddt = Q.sum(2) + ex_end * xBdS + dloga * a
    dA = (dloga * dtc).sum((0, 1, 2))

    def unchunk(g, tail, like):
        return g.reshape(Bsz, nc * Lc, *tail)[:, :T].to(like.dtype)

    return (unchunk(dx, (H, P), x), unchunk(ddt, (H,), dt), dA.to(A.dtype),
            unchunk(dB, (N,), B_), unchunk(dC, (N,), C))


def _bwd_entry():
    fn = build.load("ssd_bwd_sm90").ssd_bwd_launch
    if fn.argtypes is None:  # pointers and the stream as c_void_p, not int
        fn.argtypes = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 8 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _bwd_heads(Bsz: int, nc: int, H: int, sms: int) -> int:
    """Heads a block of the backward kernel's state and chunk passes:
    BWD_HEADS (C B^T and the loads of B and C shared by more heads), halved
    while that leaves fewer than two blocks for each of the card's ``sms``
    multiprocessors, down to one."""
    heads = BWD_HEADS
    while heads > 1 and Bsz * nc * -(-H // heads) < 2 * sms:
        heads //= 2
    return heads


def _launch_bwd(x, dt, A, B_, C, dy, dstate):
    global bwd_launches
    Bsz, T, H, P = x.shape
    N = B_.shape[-1]
    if x.dtype not in _DTYPES or B_.dtype != x.dtype or C.dtype != x.dtype:
        raise ValueError(f"ssd_bwd kernel: x, B, C must share float32 or "
                         f"bfloat16, got {x.dtype}, {B_.dtype}, {C.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise ValueError(f"ssd_bwd kernel: dt and A must be float32, got "
                         f"{dt.dtype}, {A.dtype}")
    if not (0 < P <= MAX_DIM and 0 < N <= MAX_DIM):
        raise ValueError(f"ssd_bwd kernel takes P, N <= {MAX_DIM}, got "
                         f"P={P}, N={N}")
    named = (("x", x), ("dt", dt), ("A", A), ("B", B_), ("C", C), ("dy", dy))
    if dstate is not None:
        named += (("dstate", dstate),)
    for name, t in named:
        if not t.is_contiguous():
            raise ValueError(f"ssd_bwd: {name} must be contiguous")
    if x.numel() >= 2**31 or Bsz * T * H * N >= 2**31:
        raise ValueError("ssd_bwd: too large for 32-bit indexing")
    fn = _bwd_entry()
    dx = torch.empty_like(x)
    ddt = torch.empty_like(dt)
    dA = torch.empty_like(A)
    dB = torch.empty_like(B_)
    dC = torch.empty_like(C)
    if x.numel() == 0:
        return dx, ddt, dA.zero_(), dB.zero_(), dC.zero_()
    _, nc, _ = _chunking(T)
    f32 = dict(dtype=torch.float32, device=x.device)
    dev, stream = build.device_and_stream(x)
    heads = _bwd_heads(Bsz, nc, H,
                       torch.cuda.get_device_properties(dev).multi_processor_count)
    # chunk states, then S0; G, then dS1 (B, nc, H, P, N); dB and dC of
    # each group of `heads` heads (B, T, ceil(H / heads), N); per-head dA of
    # each (b, chunk) and each chunk's exp(cum_end)
    states = torch.empty((2, Bsz, nc, H, P, N), **f32)
    parts = torch.empty((2, Bsz, T, -(-H // heads), N), **f32)
    small = torch.empty((2, Bsz * nc * H), **f32)
    err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B_.data_ptr(),
             C.data_ptr(), dy.data_ptr(),
             0 if dstate is None else dstate.data_ptr(), dx.data_ptr(),
             ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(), dC.data_ptr(),
             states[0].data_ptr(), states[1].data_ptr(), parts[0].data_ptr(),
             parts[1].data_ptr(), small[0].data_ptr(), small[1].data_ptr(),
             Bsz, T, H, P, N, heads, _DTYPES[x.dtype], dev, stream)
    if err != 0:
        raise RuntimeError(f"ssd_bwd launch failed: CUDA error {err}")
    bwd_launches += BWD_LAUNCHES_PER_CALL
    return dx, ddt, dA, dB, dC


def ssd_bwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
            B_: torch.Tensor, C: torch.Tensor, dy: torch.Tensor,
            dstate: torch.Tensor | None = None):
    """Gradients (dx, ddt, dA, dB, dC) of ``ssd(x, dt, A, B_, C)`` for the
    output gradient ``dy`` (like x) and the final state's ``dstate``
    ((B, H, P, N) float32, or None for zero): the kernel
    ``csrc/ssd_bwd_sm90.cu`` on CUDA tensors (float32 or bfloat16 x, B, C),
    ``ssd_bwd_plain`` on the CPU."""
    _check(x, dt, A, B_, C)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"ssd_bwd: dy {tuple(dy.shape)} {dy.dtype} on "
                         f"{dy.device} does not match x {tuple(x.shape)} "
                         f"{x.dtype} on {x.device}")
    Bsz, _, H, P = x.shape
    want = (Bsz, H, P, B_.shape[-1])
    if dstate is not None and (tuple(dstate.shape) != want
                               or dstate.device != x.device):
        raise ValueError(f"ssd_bwd: dstate {tuple(dstate.shape)} on "
                         f"{dstate.device}, expected {want} on {x.device}")
    if x.device.type == "cpu":
        return ssd_bwd_plain(x, dt, A, B_, C, dy, dstate)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_bwd: unsupported device {x.device}")
    if dstate is not None and dstate.dtype != torch.float32:
        raise ValueError(f"ssd_bwd kernel: dstate must be float32, got "
                         f"{dstate.dtype}")
    return _launch_bwd(x, dt, A, B_, C, dy, dstate)


SSDScan = scan_function("SSDScan", ssd, ssd_bwd, """``ssd`` with its
gradient: the forward wrapper, then ``ssd_bwd`` on the saved inputs (the
chunk-start states are recomputed in the backward, so the forward writes
nothing extra).  On CUDA tensors both directions launch kernels or raise.""")
