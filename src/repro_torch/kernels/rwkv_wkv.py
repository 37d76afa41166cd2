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

from repro_torch.kernels import build

MAX_P = 64          # the kernel's bound on the head size P (a multiple of 4)
MAX_CHUNK = 128     # the kernel's bound on the chunk length

launches = 0


def wkv_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor, num_heads: int,
              chunk_len: int):
    """r/k/v/w: (B, T, H*P), u: (H, P); T a multiple of ``chunk_len``.

    Returns (y (B, T, H*P) float32, final_state (B, H, P, P) float32), with
    the arithmetic of JAX's ``wkv_chunked`` step for step.
    """
    B, T, HP = r.shape
    H = num_heads
    P = HP // H
    Lc = chunk_len
    nc = T // Lc

    def reshape(x):  # (B, T, H*P) -> (nc, B, H, Lc, P) float32
        return x.reshape(B, nc, Lc, H, P).permute(1, 0, 3, 2, 4).float()

    r_, k_, v_, w_ = map(reshape, (r, k, v, w))
    logw = torch.log(torch.clamp_min(w_, 1e-38))  # negative
    # cumulative decay within a chunk: A[t] = prod_{s<=t} w[s]
    cum = torch.cumsum(logw, dim=3)
    A_incl = torch.exp(cum)                       # includes w_t
    A_excl = torch.exp(cum - logw)                # excludes w_t
    total = torch.exp(cum[:, :, :, -1:, :])       # (nc, B, H, 1, P)
    u_f = u.float()
    tmask = torch.tril(torch.ones((Lc, Lc), dtype=torch.bool,
                                  device=r.device), diagonal=-1)
    S = torch.zeros((B, H, P, P), dtype=torch.float32, device=r.device)
    ys = []
    for c in range(nc):
        rc, kc, vc = r_[c], k_[c], v_[c]
        Ai, Ae, tot = A_incl[c], A_excl[c], total[c]
        # inter-chunk: y_inter[t] = (r_t * A_excl[t]) @ S
        y_inter = torch.einsum("bhtp,bhpq->bhtq", rc * Ae, S)
        # intra-chunk, s < t: sum_p r_t[p] k_s[p] A_excl[t] / A_incl[s]
        qd = rc * Ae
        kd = kc / torch.clamp_min(Ai, 1e-30)
        att = torch.einsum("bhtp,bhsp->bhts", qd, kd)
        att = torch.where(tmask, att, 0.0)
        # diagonal "bonus" term: u * k_t
        diag = torch.einsum("bhtp,bhtp->bht", rc, u_f[None, :, None, :] * kc)
        y_intra = (torch.einsum("bhts,bhsp->bhtp", att, vc)
                   + diag[..., None] * vc)
        # state: S' = diag(total) S + sum_s (total / A_incl[s]) k_s v_s^T
        kw = kc * (tot / torch.clamp_min(Ai, 1e-30))
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
