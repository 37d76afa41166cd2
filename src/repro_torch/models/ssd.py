"""Mamba-2 SSD (state-space duality) pieces of the Zamba2 hybrid.

Port of ``repro.models.ssd``.  Per head h (P channels, N state dims),
scalar decay per step:

    S_t = exp(dt_t * A_h) S_{t-1} + dt_t * x_t B_t^T,    y_t = S_t C_t

``ssd_chunked`` (train and prefill) routes to the ``ssd`` kernel wrapper:
the Hopper kernel on CUDA tensors, its plain version (JAX's chunked
arithmetic) on the CPU; on CUDA tensors that want a gradient to
``SSDScan``, whose backward is the backward kernel.  ``ssd_decode`` and
``causal_conv1d`` are plain torch.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ssd as K


def ssd_chunked(x, dt, A, B_, C, *, use_kernel: bool = True):
    """x: (B,T,H,P), dt: (B,T,H) (>0), A: (H,) (<0), B_/C: (B,T,N).

    Single B/C group shared across heads.  Returns (y (B,T,H,P) like x,
    final_state (B,H,P,N) float32).  Any T: a ragged last chunk is padded
    (JAX's ``ssd_chunked`` asserts that chunks tile T).  On a CUDA tensor
    ``use_kernel=False`` takes the kernel's plain version (under autograd
    in training), and where a gradient is wanted (grad enabled, an input
    that requires it) the kernel path is ``SSDScan`` (forward and backward
    kernels).  Without a gradient (serving) the forward kernel runs alone;
    on the CPU autograd runs through the plain version, as JAX
    differentiates its ``ssd_chunked``.
    """
    args = (x.contiguous(), dt.float().contiguous(), A.float().contiguous(),
            B_.contiguous(), C.contiguous())
    if not use_kernel:
        return K.ssd_plain(*args)
    if (x.device.type == "cuda" and torch.is_grad_enabled()
            and any(t.requires_grad for t in args)):
        return K.SSDScan.apply(*args)
    return K.ssd(*args)


def ssd_decode(x, dt, A, B_, C, state):
    """One SSD step.  x: (B,1,H,P), dt: (B,1,H), B_/C: (B,1,N), state
    (B,H,P,N) float32 -> (y (B,1,H,P) like x, new state)."""
    xf = x[:, 0].float()                          # (B,H,P)
    dtf = dt[:, 0].float()                        # (B,H)
    Bf = B_[:, 0].float()                         # (B,N)
    Cf = C[:, 0].float()
    a = torch.exp(dtf * A.float()[None])          # (B,H)
    upd = torch.einsum("bhp,bn->bhpn", xf * dtf[..., None], Bf)
    state = state * a[..., None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", state, Cf)
    return y[:, None].to(x.dtype), state


def causal_conv1d(x, w, prev=None):
    """Depth-wise causal conv.  x: (B, T, C), w: (K, C), prev: (B, K-1, C).

    Products and sums in x's type (as JAX's elementwise sum), silu in
    float32.  Returns (y (B, T, C), new_prev (B, K-1, C)) for decode;
    ``new_prev`` owns its storage: a view of ``xp`` would keep the whole
    padded input alive for as long as the decode cache holds it.
    """
    K = w.shape[0]
    T = x.shape[1]
    if prev is None:
        prev = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                           device=x.device)
    xp = torch.cat([prev, x], dim=1)              # (B, T+K-1, C)
    y = xp[:, 0:T] * w[0]
    for i in range(1, K):
        y = y + xp[:, i:i + T] * w[i]
    new_prev = xp[:, -(K - 1):].clone() if K > 1 else prev
    return F.silu(y.float()).to(x.dtype), new_prev
