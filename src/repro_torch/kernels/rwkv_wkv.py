"""The RWKV-6 chunked WKV scan: wrapper, plain version and launch count.

``wkv`` is the port of ``repro/kernels/rwkv_wkv.py::wkv_pallas`` (body
``_wkv_kernel``).  Per (batch, head), with P channels, data-dependent decay
``w_t`` and bonus ``u``:

    S_t = diag(w_t) S_{t-1} + k_t v_t^T
    y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)

computed in chunks of ``chunk_len`` steps with a (P x P) float32 state
carried across them.  Inside a chunk the cumulative decay is formed from
``logw = log(max(w, 1e-38))`` and divided out with ``max(A_incl, 1e-30)``
in the denominators, exactly as the TPU kernel and JAX's
``models/rwkv.py::wkv_chunked`` do.  Those clamps bind once a chunk's
cumulative decay falls below 1e-30 (from step 57 of a chunk of 64 at the
default init's decay of 0.302); the result then differs from the naive
recurrence, and the port reproduces that rather than fixing it.

It returns ``y`` (B, T, H*P) float32 and the final state (B, H, P, P)
float32: ``wkv_pallas`` keeps the state in VMEM scratch and drops it; the
model's prefill needs it for the decode cache, as JAX's ``wkv_chunked``
returns it.  The kernel is CUDA C++ in ``csrc/wkv.cu`` (design and bound
are noted there): one block per (batch, head, chunk), with only the state
carried from chunk to chunk passed along a chain of flags; the wrapper
hands it a zeroed (1 + B*H,) int32 buffer for its ticket and flags.

For tensors on the CPU the wrapper takes ``wkv_plain``; for CUDA tensors it
launches the kernel or raises.  ``launches`` counts kernel launches and
nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, plain_dtype, scan_function

MAX_P = 64          # the kernel's bound on the head size P (a multiple of 4)
MAX_CHUNK = 128     # the kernels' bound on the chunk length (both directions)

launches = 0
bwd_launches = 0
BWD_LAUNCHES_PER_CALL = 4   # chunk states, the chain, the chunks, du's sum
W_FLOOR, A_FLOOR = 1e-38, 1e-30   # JAX's floors on w and on A_incl


def wkv_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor, num_heads: int,
              chunk_len: int):
    """r/k/v/w: (B, T, H*P), u: (H, P); T a multiple of ``chunk_len``.

    Returns (y (B, T, H*P) float32, final_state (B, H, P, P) float32), with
    the arithmetic of JAX's ``wkv_chunked`` step for step (float64 for
    float64 r, which the whole computation then keeps).
    """
    B, T, HP = r.shape
    H = num_heads
    P = HP // H
    Lc = chunk_len
    nc = T // Lc
    ft = plain_dtype(r)

    def reshape(x):  # (B, T, H*P) -> (nc, B, H, Lc, P) in ft
        return x.reshape(B, nc, Lc, H, P).permute(1, 0, 3, 2, 4).to(ft)

    r_, k_, v_, w_ = map(reshape, (r, k, v, w))
    logw = torch.log(torch.clamp_min(w_, W_FLOOR))  # negative
    # cumulative decay within a chunk: A[t] = prod_{s<=t} w[s]
    cum = torch.cumsum(logw, dim=3)
    A_incl = torch.exp(cum)                       # includes w_t
    A_excl = torch.exp(cum - logw)                # excludes w_t
    total = torch.exp(cum[:, :, :, -1:, :])       # (nc, B, H, 1, P)
    u_f = u.to(ft)
    tmask = torch.tril(torch.ones((Lc, Lc), dtype=torch.bool,
                                  device=r.device), diagonal=-1)
    S = torch.zeros((B, H, P, P), dtype=ft, device=r.device)
    ys = []
    for c in range(nc):
        rc, kc, vc = r_[c], k_[c], v_[c]
        Ai, Ae, tot = A_incl[c], A_excl[c], total[c]
        # inter-chunk: y_inter[t] = (r_t * A_excl[t]) @ S
        y_inter = torch.einsum("bhtp,bhpq->bhtq", rc * Ae, S)
        # intra-chunk, s < t: sum_p r_t[p] k_s[p] A_excl[t] / A_incl[s]
        qd = rc * Ae
        kd = kc / torch.clamp_min(Ai, A_FLOOR)
        att = torch.einsum("bhtp,bhsp->bhts", qd, kd)
        att = torch.where(tmask, att, 0.0)
        # diagonal "bonus" term: u * k_t
        diag = torch.einsum("bhtp,bhtp->bht", rc, u_f[None, :, None, :] * kc)
        y_intra = (torch.einsum("bhts,bhsp->bhtp", att, vc)
                   + diag[..., None] * vc)
        # state: S' = diag(total) S + sum_s (total / A_incl[s]) k_s v_s^T
        kw = kc * (tot / torch.clamp_min(Ai, A_FLOOR))
        S = S * tot.transpose(-1, -2) + torch.einsum("bhsp,bhsq->bhpq", kw, vc)
        ys.append(y_inter + y_intra)
    y = torch.stack(ys).permute(1, 0, 3, 2, 4).reshape(B, T, HP)
    return y, S


def _check(r, k, v, w, u, num_heads, chunk_len) -> None:
    if r.dim() != 3:
        raise ValueError(f"r must be (B, T, H*P), got {tuple(r.shape)}")
    B, T, HP = r.shape
    if any(t.shape != r.shape for t in (k, v, w)):
        raise ValueError(f"r/k/v/w shapes differ: {tuple(r.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}, "
                         f"{tuple(w.shape)}")
    if num_heads < 1 or HP % num_heads:
        raise ValueError(f"{HP} channels do not split into {num_heads} heads")
    if tuple(u.shape) != (num_heads, HP // num_heads):
        raise ValueError(f"u must be (H, P) = ({num_heads}, "
                         f"{HP // num_heads}), got {tuple(u.shape)}")
    if chunk_len < 1 or T % chunk_len:
        raise ValueError(f"T={T} is not a whole number of chunks of "
                         f"{chunk_len}")
    if len({t.device for t in (r, k, v, w, u)}) != 1:
        raise ValueError("wkv: every input must lie on one device")


def _entry():
    fn = build.load("wkv").wkv_launch
    if fn.argtypes is None:  # pointers and the stream as c_void_p, not int
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _launch(r, k, v, w, u, num_heads, chunk_len):
    global launches
    B, T, HP = r.shape
    P = HP // num_heads
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w), ("u", u)):
        if t.dtype != torch.float32:
            raise ValueError(f"wkv kernel takes float32 inputs, got {name} "
                             f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"wkv: {name} must be contiguous")
    if not 0 < P <= MAX_P or P % 4:
        raise ValueError(f"wkv kernel takes P <= {MAX_P}, a multiple of 4, "
                         f"got P={P}")
    if any(t.data_ptr() % 16 for t in (r, k, v, w)):
        raise ValueError("wkv kernel: r, k, v and w must be 16-byte aligned "
                         "(it loads them in 16-byte pieces)")
    if chunk_len > MAX_CHUNK:
        raise ValueError(f"wkv kernel takes chunks of at most {MAX_CHUNK} "
                         f"steps, got {chunk_len}")
    if r.numel() >= 2**31:
        raise ValueError("wkv: too large for 32-bit indexing")
    fn = _entry()
    y = torch.empty_like(r)
    state = torch.empty((B, num_heads, P, P), dtype=torch.float32,
                        device=r.device)
    if r.numel() == 0:
        return y, state.zero_()
    sync = torch.zeros(1 + B * num_heads, dtype=torch.int32, device=r.device)
    dev, stream = build.device_and_stream(r)
    err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
             u.data_ptr(), y.data_ptr(), state.data_ptr(), sync.data_ptr(), B,
             T, num_heads, P, chunk_len, dev, stream)
    if err != 0:
        raise RuntimeError(f"wkv launch failed: CUDA error {err}")
    launches += 1
    return y, state


def wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
        u: torch.Tensor, num_heads: int, chunk_len: int):
    """r/k/v/w: (B, T, H*P), u: (H, P), T a multiple of ``chunk_len`` ->
    (y (B, T, H*P) float32, final_state (B, H, P, P) float32)."""
    _check(r, k, v, w, u, num_heads, chunk_len)
    if r.device.type == "cpu":
        return wkv_plain(r, k, v, w, u, num_heads, chunk_len)
    if r.device.type != "cuda":
        raise ValueError(f"wkv: unsupported device {r.device}")
    return _launch(r, k, v, w, u, num_heads, chunk_len)


# ------------------------------------------------------------- backward --

def wkv_bwd_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  w: torch.Tensor, u: torch.Tensor, num_heads: int,
                  chunk_len: int, dy: torch.Tensor,
                  dstate: torch.Tensor | None = None):
    """The VJP of ``wkv_plain``, written out by hand: for the output
    gradient ``dy`` (B, T, H*P) and the final state's ``dstate`` (B, H, P,
    P; None is zero) returns (dr, dk, dv, dw like r, du like u).

    Per chunk, with qd = r A_excl, kd = k / D, kw = k total / D (D =
    max(A_incl, 1e-30)), att[t, s] = qd_t . kd_s for s < t, S0 the state at
    the chunk's start and dS1 the gradient of the state at its end (from a
    pass over the chunks), and datt[t, s] = dy_t . v_s (s < t):

        dqd_t = S0 dy_t + sum_s datt kd_s      dkd_s = sum_t datt qd_t
        dkw_s = dS1 v_s                        dv_s  = sum_t att dy_t
                                                       + bonus_s dy_s
                                                       + dS1^T kw_s
        dr = dqd A_excl + (dy.v) u k           dk = (dkd + dkw total) / D
                                                    + (dy.v) u r
        dS0 = diag(total) dS1 + sum_t qd_t dy_t^T

    and the decay's gradient through the cumulative log-decay cum: the
    terms dqd qd (A_excl), -(dkd kd + dkw kw) where the 1e-30 floor does
    not bind (A_incl; the floor's derivative is 0, as JAX's ``maximum``
    gives), at the last step total (S0 . dS1) + sum_s dkw kw (total);
    reverse-summed over the chunk, less dqd qd (A_excl leaves out w_t),
    over w where the 1e-38 floor does not bind.  Every term is a product
    of values the forward forms, none is divided by A_incl squared: JAX's
    autodiff of ``kd = k / max(A_incl, 1e-30)`` is, and overflows to NaN
    once the decay passes ~1e-19.  float64 inputs are computed in float64,
    all others in float32.
    """
    B, T, HP = r.shape
    H = num_heads
    P = HP // H
    Lc = chunk_len
    nc = T // Lc
    ft = plain_dtype(r)

    def reshape(x):  # (B, T, H*P) -> (B, nc, H, Lc, P) in ft
        return x.reshape(B, nc, Lc, H, P).permute(0, 1, 3, 2, 4).to(ft)

    r_, k_, v_, w_, dy_ = map(reshape, (r, k, v, w, dy))
    uu = u.to(ft)[None, None, :, None, :]
    logw = torch.log(torch.clamp_min(w_, W_FLOOR))
    cum = torch.cumsum(logw, dim=3)
    Ai = torch.exp(cum)
    Ae = torch.exp(cum - logw)
    tot = torch.exp(cum[:, :, :, -1])                     # (B, nc, H, P)
    D = torch.clamp_min(Ai, A_FLOOR)
    qd = r_ * Ae
    kd = k_ / D
    kw = k_ * (tot[:, :, :, None] / D)
    strict = torch.tril(torch.ones((Lc, Lc), dtype=torch.bool,
                                   device=r.device), diagonal=-1)
    att = torch.where(strict, torch.einsum("bchtp,bchsp->bchts", qd, kd),
                      0.0)
    bonus = (r_ * uu * k_).sum(-1)                        # (B, nc, H, Lc)

    # the chunk-start states S0 and the end-of-chunk state gradients dS1
    loc = torch.einsum("bchsp,bchsq->bchpq", kw, v_)
    G = torch.einsum("bchtp,bchtq->bchpq", qd, dy_)
    S = torch.zeros((B, H, P, P), dtype=ft, device=r.device)
    starts = []
    for c in range(nc):
        starts.append(S)
        S = tot[:, c, :, :, None] * S + loc[:, c]
    dS = torch.zeros_like(S) if dstate is None else dstate.to(ft)
    ends = [None] * nc
    for c in reversed(range(nc)):
        ends[c] = dS
        dS = tot[:, c, :, :, None] * dS + G[:, c]
    S0, dS1 = torch.stack(starts, 1), torch.stack(ends, 1)

    datt = torch.where(strict, torch.einsum("bchtq,bchsq->bchts", dy_, v_),
                       0.0)
    dbonus = (dy_ * v_).sum(-1)                           # (B, nc, H, Lc)
    dqd = (torch.einsum("bchtq,bchpq->bchtp", dy_, S0)
           + torch.einsum("bchts,bchsp->bchtp", datt, kd))
    dkd = torch.einsum("bchts,bchtp->bchsp", datt, qd)
    dkw = torch.einsum("bchpq,bchsq->bchsp", dS1, v_)
    dv = (torch.einsum("bchts,bchtq->bchsq", att, dy_)
          + bonus[..., None] * dy_
          + torch.einsum("bchsp,bchpq->bchsq", kw, dS1))
    dr = dqd * Ae + dbonus[..., None] * uu * k_
    dk = (dkd + dkw * tot[:, :, :, None]) / D + dbonus[..., None] * uu * r_
    du = (dbonus[..., None] * r_ * k_).sum((0, 1, 3))
    dqd_qd = dqd * qd
    dcum = dqd_qd - torch.where(Ai > A_FLOOR, dkd * kd + dkw * kw, 0.0)
    dcum[:, :, :, -1] += (tot * (S0 * dS1).sum(-1)
                          + (dkw * kw).sum(3))
    dlogw = (torch.flip(torch.cumsum(torch.flip(dcum, (3,)), 3), (3,))
             - dqd_qd)
    dw = torch.where(w_ > W_FLOOR, dlogw / w_, 0.0)

    def back(g):  # (B, nc, H, Lc, P) -> (B, T, H*P) like r
        return g.permute(0, 1, 3, 2, 4).reshape(B, T, HP).to(r.dtype)

    return back(dr), back(dk), back(dv), back(dw), du.to(u.dtype)


def _bwd_entry():
    fn = build.load("wkv_bwd").wkv_bwd_launch
    if fn.argtypes is None:  # pointers and the stream as c_void_p, not int
        fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _launch_bwd(r, k, v, w, u, num_heads, chunk_len, dy, dstate):
    global bwd_launches
    B, T, HP = r.shape
    P = HP // num_heads
    named = (("r", r), ("k", k), ("v", v), ("w", w), ("u", u), ("dy", dy))
    if dstate is not None:
        named += (("dstate", dstate),)
    for name, t in named:
        if t.dtype != torch.float32:
            raise ValueError(f"wkv_bwd kernel takes float32 inputs, got "
                             f"{name} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"wkv_bwd: {name} must be contiguous")
    if not 0 < P <= MAX_P:
        raise ValueError(f"wkv_bwd kernel takes P <= {MAX_P}, got P={P}")
    if chunk_len > MAX_CHUNK:
        raise ValueError(f"wkv_bwd kernel takes chunks of at most "
                         f"{MAX_CHUNK} steps, got {chunk_len}")
    if r.numel() >= 2**31:
        raise ValueError("wkv_bwd: too large for 32-bit indexing")
    fn = _bwd_entry()
    dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
    du = torch.empty_like(u)
    if r.numel() == 0:
        return dr, dk, dv, dw, du.zero_()
    nc = T // chunk_len
    f32 = dict(dtype=torch.float32, device=r.device)
    # chunk states, then S0; G, then dS1 (B, nc, H, P, P); each chunk's
    # total (B, nc, H, P); each block's share of du (B * nc, H, P)
    states = torch.empty((2, B, nc, num_heads, P, P), **f32)
    small = torch.empty((2, B * nc * num_heads * P), **f32)
    dev, stream = build.device_and_stream(r)
    err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
             u.data_ptr(), dy.data_ptr(),
             0 if dstate is None else dstate.data_ptr(), dr.data_ptr(),
             dk.data_ptr(), dv.data_ptr(), dw.data_ptr(), du.data_ptr(),
             states[0].data_ptr(), states[1].data_ptr(), small.data_ptr(),
             B, T, num_heads, P, chunk_len, dev, stream)
    if err != 0:
        raise RuntimeError(f"wkv_bwd launch failed: CUDA error {err}")
    bwd_launches += BWD_LAUNCHES_PER_CALL
    return dr, dk, dv, dw, du


def wkv_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            w: torch.Tensor, u: torch.Tensor, num_heads: int, chunk_len: int,
            dy: torch.Tensor, dstate: torch.Tensor | None = None):
    """Gradients (dr, dk, dv, dw, du) of ``wkv(r, k, v, w, u, num_heads,
    chunk_len)`` for the output gradient ``dy`` (B, T, H*P) and the final
    state's ``dstate`` ((B, H, P, P), or None for zero): the kernel
    ``csrc/wkv_bwd.cu`` on CUDA tensors (float32, chunks of at most
    ``MAX_CHUNK`` steps, as the forward kernel), ``wkv_bwd_plain`` on
    the CPU."""
    _check(r, k, v, w, u, num_heads, chunk_len)
    if dy.shape != r.shape or dy.device != r.device:
        raise ValueError(f"wkv_bwd: dy {tuple(dy.shape)} on {dy.device} "
                         f"does not match r {tuple(r.shape)} on {r.device}")
    B, _, HP = r.shape
    P = HP // num_heads
    if dstate is not None and (tuple(dstate.shape) != (B, num_heads, P, P)
                               or dstate.device != r.device):
        raise ValueError(f"wkv_bwd: dstate {tuple(dstate.shape)} on "
                         f"{dstate.device}, expected "
                         f"{(B, num_heads, P, P)} on {r.device}")
    if r.device.type == "cpu":
        return wkv_bwd_plain(r, k, v, w, u, num_heads, chunk_len, dy, dstate)
    if r.device.type != "cuda":
        raise ValueError(f"wkv_bwd: unsupported device {r.device}")
    return _launch_bwd(r, k, v, w, u, num_heads, chunk_len, dy, dstate)


WKVScan = scan_function("WKVScan", wkv, wkv_bwd, """``wkv`` with its
gradient: the forward wrapper, then ``wkv_bwd`` on the saved inputs (the
chunk-start states are recomputed in the backward, so the forward writes
nothing extra).  On CUDA tensors both directions launch kernels or raise;
both take chunks of up to ``MAX_CHUNK`` steps.""")
