"""RWKV-6 ("Finch") time mix and channel mix: attention-free sequence
mixing with data-dependent decay.

Port of ``repro.models.rwkv``.  Per head (size P) the state S (P x P)
evolves as

    S_t = diag(w_t) S_{t-1} + k_t v_t^T
    y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)

with decay w_t = exp(-exp(min(w0 + LoRA_w(x_t), 0.18))).  ``wkv_chunked``
(train and prefill) routes to the ``wkv`` kernel wrapper: the Hopper
kernel on CUDA tensors, its plain version (JAX's chunked arithmetic) on the
CPU; on CUDA tensors that want a gradient to ``WKVScan``, whose backward
is the backward kernel.  ``wkv_decode`` is plain torch.

Types follow JAX's promotion: the token-shift mix of a bfloat16 activation
with a float32 ``mu`` is float32, so r, k, v, g, w and the channel mix's
key and receptance products are float32 products of the widened weights.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import rwkv_wkv as K


def token_shift(x: torch.Tensor, prev: torch.Tensor | None = None):
    """The x[t-1] stream.  x: (B, T, D); prev: (B, 1, D) carry for decode."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    return torch.cat([prev, x[:, :-1]], dim=1)


def time_mix_params_apply(x, xs, p):
    """Per-token r, k, v, g, w (each (B, T, D) float32) from the
    token-shifted mixes; ``p`` is the layer holding JAX's parameters."""
    def mix(mu):
        return x + (xs - x) * mu

    r = mix(p.mu_r) @ p.w_r.float()
    k = mix(p.mu_k) @ p.w_k.float()
    v = mix(p.mu_v) @ p.w_v.float()
    g = mix(p.mu_g) @ p.w_g.float()
    # the clamp bounds each token's decay at w >= exp(-exp(0.18)) ~ 0.302
    ww = p.w0 + torch.tanh(mix(p.mu_w) @ p.wA) @ p.wB
    w = torch.exp(-torch.exp(torch.clamp_max(ww.float(), 0.18)))
    return r, k, v, g, w


def chunk_len(T: int, chunk: int = 64) -> int:
    """JAX's chunking of T steps: ``max(1, T // chunk)`` chunks of equal
    length; raises where JAX's ``wkv_chunked`` asserts."""
    nc = max(1, T // chunk)
    Lc = T // nc
    if nc * Lc != T:
        raise ValueError(f"T={T} not divisible into chunks of {chunk}")
    return Lc


def wkv_chunked(r, k, v, w, u, num_heads: int, chunk: int = 64, *,
                use_kernel: bool = True):
    """Chunked WKV-6.  r/k/v/w: (B, T, H*P), u: (H, P).

    Returns (y (B, T, H*P) float32, final_state (B, H, P, P) float32).  On
    a CUDA tensor ``use_kernel=False`` takes the kernel's plain version
    (under autograd in training), and where a gradient is wanted (grad
    enabled, an input that requires it) the kernel path is ``WKVScan``
    (forward and backward kernels).  Without a gradient (serving) the
    forward kernel runs alone; on the CPU autograd runs through the plain
    version, as JAX differentiates its ``wkv_chunked``.
    """
    Lc = chunk_len(r.shape[1], chunk)
    args = [t.float().contiguous() for t in (r, k, v, w, u)]
    if not use_kernel:
        return K.wkv_plain(*args, num_heads, Lc)
    if (r.device.type == "cuda" and torch.is_grad_enabled()
            and any(t.requires_grad for t in args)):
        return K.WKVScan.apply(*args, num_heads, Lc)
    return K.wkv(*args, num_heads, Lc)


def wkv_decode(r, k, v, w, u, state):
    """One-token WKV update.  r/k/v/w: (B, 1, H*P); state (B, H, P, P)."""
    B, _, HP = r.shape
    H, P = state.shape[1], state.shape[2]
    rf, kf, vf, wf = (t.reshape(B, H, P).float() for t in (r, k, v, w))
    kv = torch.einsum("bhp,bhq->bhpq", kf, vf)
    y = torch.einsum("bhp,bhpq->bhq", rf,
                     state + u.float()[None, :, :, None] * kv)
    state = state * wf[..., None] + kv
    return y.reshape(B, 1, HP), state


def channel_mix(x, xs, p):
    """RWKV channel mix: sigmoid(r) * W_v relu(W_k mix)^2, in x's type."""
    xk = x + (xs - x) * p.mu_ck
    xr = x + (xs - x) * p.mu_cr
    kk = xk @ p.w_ck.float()
    kk = torch.square(F.relu(kk.float())).to(x.dtype)
    vv = kk @ p.w_cv
    rr = torch.sigmoid((xr @ p.w_cr.float()).float())
    return (rr * vv.float()).to(x.dtype)
