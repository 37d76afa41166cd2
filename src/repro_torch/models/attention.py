"""Attention: RoPE and M-RoPE, full-sequence attention through the flash
kernel, and single-token decode attention over the KV cache.

Port of ``repro.models.attention``.  JAX's ``attention()``
runs its pure-jnp ``flash_mha`` (or ``_sliding_window`` past the window);
the port routes the same call to the ``flash_attention`` wrapper (to
``FlashAttention`` when grad is on, with the backward kernel), which
computes the same function: the Hopper kernel on CUDA tensors, its plain
version on the CPU.  The layout stays JAX's (B, S, H, hd) and GQA keeps
JAX's head order (query head h reads KV head h // (H // KV)).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import flash_attention as FA

NEG_INF = FA.NEG_INF


def rope_freqs(head_dim: int, theta: float,
               device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               mrope_sections: tuple = ()) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S), or (3, B, S) for M-RoPE.
    Rotates in float32.

    With ``mrope_sections`` (Qwen2-VL's M-RoPE) frequency channel c of the
    hd/2 reads position stream ``sec[c]``, where ``sec`` repeats stream
    index i ``mrope_sections[i]`` times (temporal, height, width); the
    angle is that position times the channel's frequency, one float32
    product as in JAX's ``einsum("cbs,c->bsc")``, so three equal streams
    give plain RoPE bit for bit.
    """
    hd = x.shape[-1]
    inv = rope_freqs(hd, theta, x.device)
    if mrope_sections:
        if positions.dim() != 3 or positions.shape[0] != len(mrope_sections):
            raise ValueError(f"M-RoPE needs ({len(mrope_sections)}, B, S) "
                             f"positions, got {tuple(positions.shape)}")
        if sum(mrope_sections) != hd // 2:
            raise ValueError(f"M-RoPE sections {mrope_sections} do not "
                             f"cover hd/2 = {hd // 2} channels")
        pos = positions.float()
        per_channel = torch.cat([pos[i, ..., None].expand(*pos.shape[1:], n)
                                 for i, n in enumerate(mrope_sections)],
                                dim=-1)                 # (B, S, hd/2)
        angles = per_channel * inv
    else:
        angles = positions.float()[..., None] * inv      # (B, S, hd/2)
    sin = torch.sin(angles)[..., None, :]
    cos = torch.cos(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, sliding_window: int = 0,
              use_kernel: bool = True) -> torch.Tensor:
    """Multi-head attention over full sequences (train and prefill).

    q: (B, S, H, hd); k, v: (B, S, KV, hd) with H % KV == 0.  On a CUDA
    tensor ``use_kernel=False`` takes the kernel's plain version (under
    autograd in training).  With grad enabled the kernel path is
    ``FlashAttention``, whose backward is the backward kernel (the plain
    formulas on the CPU), as JAX's ``flash_mha`` carries its custom VJP.

    Routed as JAX's ``attention()``: a window that binds (``sliding_window
    > 0`` and S past it) takes JAX's ``_sliding_window`` path, which is
    causal whatever ``causal`` says; otherwise the full path with
    ``causal`` as given and no window.
    """
    if sliding_window > 0 and q.shape[1] > sliding_window:
        causal = True
    else:
        sliding_window = 0
    if not use_kernel:
        return FA.flash_attention_plain(q, k, v, causal=causal,
                                        sliding_window=sliding_window)
    if torch.is_grad_enabled():
        return FA.FlashAttention.apply(q, k, v, causal, sliding_window)
    return FA.flash_attention(q, k, v, causal=causal,
                              sliding_window=sliding_window)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: int, *,
                     sliding_window: int = 0) -> torch.Tensor:
    """Single-token attention: q (B, 1, H, hd), caches (B, S, KV, hd) of
    which the first ``cache_len`` positions are filled.  Plain torch (no
    TPU kernel exists for it); JAX masks positions >= cache_len, the port
    reads only the filled ones."""
    B, _, H, hd = q.shape
    KV = k_cache.shape[2]
    G = H // KV
    k = k_cache[:, :cache_len].float()
    v = v_cache[:, :cache_len].float()
    qg = q.reshape(B, KV, G, hd).float()
    s = torch.einsum("bkgd,bskd->bkgs", qg, k) * (1.0 / math.sqrt(hd))
    if sliding_window > 0:
        # the query sits at position cache_len - 1 and sees `window` keys back
        pos = torch.arange(cache_len, device=q.device)
        s = torch.where(pos >= cache_len - 1 - sliding_window, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, v)
    return out.reshape(B, 1, H, hd).to(q.dtype)
