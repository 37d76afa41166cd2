"""Layer kinds of the slice as ``nn.Module``s, and their caches.

Port of ``repro.models.blocks`` for every kind: dense, enc (the
bidirectional encoder block, JAX's dense layer under ``cfg.causal``
False), moe, mamba, mamba_shared_attn and rwkv.  Every layer is called as
``layer(cfg, x, mode, cache, start, pos)`` and returns ``(x, cache)``:

* ``TRAIN``: full sequence, no cache (``cache`` is None);
* ``PREFILL``: full sequence from position 0, filling ``cache``;
* ``DECODE``: one token written at cache index ``start``, reading and
  updating the cache.

``pos`` is the model's (B, T) positions, or (3, B, T) under M-RoPE, which
the attention layers rotate by; the mamba and rwkv kinds ignore it.

Parameters keep the JAX package's names and its (in, out) layouts, so a
JAX parameter tree maps onto them name for name.  The Zamba2 shared block
is one ``DenseLayer`` owned by the model and passed to every
``MambaSharedLayer``, each with its own attention cache.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch.models import attention as A
from repro_torch.models import rwkv as R
from repro_torch.models import ssd as S
from repro_torch.models.common import (
    DENSE,
    ENC,
    MAMBA,
    MAMBA_SHARED_ATTN,
    MOE,
    RWKV,
    LayerSpec,
    ModelConfig,
    init_dense,
    rms_norm,
)
from repro_torch.models.ffn import moe_ffn, swiglu

TRAIN, PREFILL, DECODE = "train", "prefill", "decode"


def new_param(shape, dtype, device) -> nn.Parameter:
    """An uninitialised parameter, frozen: inference builds no autograd
    graph.  Training switches every parameter on with
    ``model.requires_grad_()`` (``train.init_train_state`` and
    ``make_train_step`` do), and ``TRAIN`` mode then differentiates every
    layer kind."""
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


# ------------------------------------------------------------ dense layer --

class DenseLayer(nn.Module):
    """GQA attention + SwiGLU MLP (JAX ``init_dense_layer`` /
    ``apply_dense_layer``), causal or not as ``cfg.causal`` says."""

    def __init__(self, cfg: ModelConfig, spec: LayerSpec, device):
        super().__init__()
        D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        f32, dt = torch.float32, cfg.dtype
        self.spec = spec
        self.ln1 = new_param((D,), f32, device)
        self.wq = new_param((D, H * hd), dt, device)
        self.wk = new_param((D, KV * hd), dt, device)
        self.wv = new_param((D, KV * hd), dt, device)
        self.wo = new_param((H * hd, D), dt, device)
        self.ln2 = new_param((D,), f32, device)
        self._ffn_params(cfg, device)

    def _ffn_params(self, cfg, device) -> None:
        D, dt = cfg.d_model, cfg.dtype
        self.w_gate = new_param((D, cfg.d_ff), dt, device)
        self.w_up = new_param((D, cfg.d_ff), dt, device)
        self.w_down = new_param((cfg.d_ff, D), dt, device)

    def _weights(self):
        """The fan-in-initialised weights, in JAX's init order."""
        return (self.wq, self.wk, self.wv, self.wo, self.w_gate, self.w_up,
                self.w_down)

    def init_params(self, g: torch.Generator) -> None:
        self.ln1.zero_()
        self.ln2.zero_()
        for w in self._weights():
            init_dense(w, g)

    def _ffn(self, cfg, h):
        return swiglu(h, self.w_gate, self.w_up, self.w_down)

    def _attn(self, cfg, x, mode, cache, start, pos):
        B, T, D = x.shape
        H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        theta, sec = self.spec.rope_theta, cfg.mrope_sections
        h = rms_norm(x, self.ln1, cfg.norm_eps)
        q = A.apply_rope((h @ self.wq).reshape(B, T, H, hd), pos, theta, sec)
        k = A.apply_rope((h @ self.wk).reshape(B, T, KV, hd), pos, theta, sec)
        v = (h @ self.wv).reshape(B, T, KV, hd)
        if mode == DECODE:
            cache["k"][:, start] = k[:, 0]
            cache["v"][:, start] = v[:, 0]
            out = A.decode_attention(q, cache["k"], cache["v"], start + 1,
                                     sliding_window=self.spec.sliding_window)
        else:
            out = A.attention(q, k, v, causal=cfg.causal,
                              sliding_window=self.spec.sliding_window,
                              use_kernel=cfg.use_kernels)
            if mode == PREFILL:
                cache["k"][:, :T] = k
                cache["v"][:, :T] = v
        return x + out.reshape(B, T, H * hd) @ self.wo

    def forward(self, cfg, x, mode, cache, start, pos, shared=None):
        x = self._attn(cfg, x, mode, cache, start, pos)
        h = rms_norm(x, self.ln2, cfg.norm_eps)
        return x + self._ffn(cfg, h), cache


class MoeLayer(DenseLayer):
    """GQA attention + the capacity-based MoE (JAX ``init_moe_layer`` /
    ``apply_moe_layer`` on one device): router float32 (D, E), ``w_gate``
    and ``w_up`` (E, D, F), ``w_down`` (E, F, D) with fan-in F."""

    def _ffn_params(self, cfg, device) -> None:
        D, Fd, E, dt = cfg.d_model, cfg.d_ff, cfg.num_experts, cfg.dtype
        self.router = new_param((D, E), torch.float32, device)
        self.w_gate = new_param((E, D, Fd), dt, device)
        self.w_up = new_param((E, D, Fd), dt, device)
        self.w_down = new_param((E, Fd, D), dt, device)

    def _weights(self):
        return (self.wq, self.wk, self.wv, self.wo, self.router, self.w_gate,
                self.w_up, self.w_down)

    def _ffn(self, cfg, h):
        return moe_ffn(h, self.router, self.w_gate, self.w_up, self.w_down,
                       experts_per_tok=cfg.experts_per_tok,
                       capacity_factor=cfg.capacity_factor,
                       block_dispatch=cfg.moe_impl != "naive")


def _attn_cache(cfg, B, S_, device) -> dict:
    shape = (B, S_, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}


# ------------------------------------------------------------ mamba layer --

def mamba_dims(cfg: ModelConfig):
    d_in = cfg.ssm_expand * cfg.d_model
    H = d_in // cfg.ssm_head_dim
    N = cfg.ssm_state
    return d_in, H, N, d_in + 2 * N


class MambaLayer(nn.Module):
    """Mamba-2 SSD block (JAX ``init_mamba_layer`` / ``apply_mamba_layer``)."""

    def __init__(self, cfg: ModelConfig, spec: LayerSpec, device):
        super().__init__()
        D = cfg.d_model
        d_in, H, N, conv_ch = mamba_dims(cfg)
        f32, dt = torch.float32, cfg.dtype
        self.spec = spec
        self.ln = new_param((D,), f32, device)
        self.in_proj = new_param((D, 2 * d_in + 2 * N + H), dt, device)
        self.conv_w = new_param((cfg.ssm_conv, conv_ch), dt, device)
        self.A_log = new_param((H,), f32, device)
        self.dt_bias = new_param((H,), f32, device)
        self.D_skip = new_param((H,), f32, device)
        self.gnorm = new_param((d_in,), f32, device)
        self.out_proj = new_param((d_in, D), dt, device)

    def init_params(self, g: torch.Generator) -> None:
        H = self.A_log.shape[0]
        self.ln.zero_()
        init_dense(self.in_proj, g)
        init_dense(self.conv_w, g, scale=0.5)
        self.A_log.copy_(torch.log(torch.linspace(1.0, 16.0, H)))
        self.dt_bias.fill_(-2.0)
        self.D_skip.fill_(1.0)
        self.gnorm.zero_()
        init_dense(self.out_proj, g)

    def forward(self, cfg, x, mode, cache, start, pos, shared=None):
        B, T, D = x.shape
        d_in, H, N, conv_ch = mamba_dims(cfg)
        h = rms_norm(x, self.ln, cfg.norm_eps)
        z, xbc, dt = (h @ self.in_proj).split([d_in, conv_ch, H], dim=-1)
        prev = cache["conv"] if mode == DECODE else None
        xbc, conv_state = S.causal_conv1d(xbc, self.conv_w, prev)
        xs, B_, C = xbc.split([d_in, N, N], dim=-1)
        dt = F.softplus(dt.float() + self.dt_bias)
        A_ = -torch.exp(self.A_log)
        xh = xs.reshape(B, T, H, cfg.ssm_head_dim)
        if mode == DECODE:
            y, ssm = S.ssd_decode(xh, dt, A_, B_, C, cache["ssm"])
        else:
            y, ssm = S.ssd_chunked(xh, dt, A_, B_, C,
                                   use_kernel=cfg.use_kernels)
        y = y + self.D_skip[None, None, :, None].to(y.dtype) * xh
        y = rms_norm(y.reshape(B, T, d_in), self.gnorm, cfg.norm_eps)
        y = y * F.silu(z.float()).to(y.dtype)
        x = x + y.to(x.dtype) @ self.out_proj
        if mode != TRAIN:
            cache["ssm"], cache["conv"] = ssm, conv_state
        return x, cache


def _mamba_cache(cfg, B, device) -> dict:
    d_in, H, N, conv_ch = mamba_dims(cfg)
    return {
        "ssm": torch.zeros((B, H, cfg.ssm_head_dim, N), dtype=torch.float32,
                           device=device),
        "conv": torch.zeros((B, cfg.ssm_conv - 1, conv_ch), dtype=cfg.dtype,
                            device=device),
    }


class MambaSharedLayer(MambaLayer):
    """Mamba block followed by the Zamba2 shared attention+MLP block (JAX
    ``apply_mamba_shared``): one parameter set for every application, one
    cache per application."""

    def forward(self, cfg, x, mode, cache, start, pos, shared=None):
        sub = cache or {"mamba": None, "shared_attn": None}
        x, _ = super().forward(cfg, x, mode, sub["mamba"], start, pos)
        x, _ = shared(cfg, x, mode, sub["shared_attn"], start, pos)
        return x, cache


# ------------------------------------------------------------- rwkv layer --

class RwkvLayer(nn.Module):
    """RWKV-6 time mix + channel mix (JAX ``init_rwkv_layer`` /
    ``apply_rwkv_layer``)."""

    def __init__(self, cfg: ModelConfig, spec: LayerSpec, device):
        super().__init__()
        D, Fd, H = cfg.d_model, cfg.d_ff, cfg.num_heads
        lora_r = max(32, D // 64)
        f32, dt = torch.float32, cfg.dtype
        self.spec = spec
        self.ln1 = new_param((D,), f32, device)
        self.ln2 = new_param((D,), f32, device)
        for n in "rkvgw":
            setattr(self, f"mu_{n}", new_param((D,), f32, device))
        for n in "rkvgo":
            setattr(self, f"w_{n}", new_param((D, D), dt, device))
        self.w0 = new_param((D,), f32, device)
        self.wA = new_param((D, lora_r), f32, device)
        self.wB = new_param((lora_r, D), f32, device)
        self.u = new_param((H, D // H), f32, device)
        self.ln_x = new_param((D,), f32, device)
        self.mu_ck = new_param((D,), f32, device)
        self.mu_cr = new_param((D,), f32, device)
        self.w_ck = new_param((D, Fd), dt, device)
        self.w_cv = new_param((Fd, D), dt, device)
        self.w_cr = new_param((D, D), dt, device)

    def init_params(self, g: torch.Generator) -> None:
        for n in ("ln1", "ln2", "ln_x", "wB"):
            getattr(self, n).zero_()
        for n in ("mu_r", "mu_k", "mu_v", "mu_g", "mu_w", "mu_ck", "mu_cr"):
            getattr(self, n).fill_(0.5)
        self.w0.fill_(0.6)
        for w in (self.w_r, self.w_k, self.w_v, self.w_g, self.w_o):
            init_dense(w, g)
        init_dense(self.wA, g, scale=0.1)
        init_dense(self.u, g, scale=0.5)
        for w in (self.w_ck, self.w_cv, self.w_cr):
            init_dense(w, g)

    def forward(self, cfg, x, mode, cache, start, pos, shared=None):
        H = cfg.num_heads
        # ---- time mix
        h = rms_norm(x, self.ln1, cfg.norm_eps)
        hs = R.token_shift(h, cache["shift_t"] if mode == DECODE else None)
        r, k, v, g, w = R.time_mix_params_apply(h, hs, self)
        if mode == DECODE:
            y, state = R.wkv_decode(r, k, v, w, self.u, cache["state"])
        else:
            y, state = R.wkv_chunked(r, k, v, w, self.u, H,
                                     chunk=min(64, x.shape[1]),
                                     use_kernel=cfg.use_kernels)
        y = rms_norm(y.to(x.dtype), self.ln_x, cfg.norm_eps)
        y = y * F.silu(g.float()).to(x.dtype)
        x = x + y @ self.w_o
        # ---- channel mix
        h2 = rms_norm(x, self.ln2, cfg.norm_eps)
        hs2 = R.token_shift(h2, cache["shift_c"] if mode == DECODE else None)
        x = x + R.channel_mix(h2, hs2, self)
        if mode != TRAIN:
            # copies, so that the cache does not keep the whole h alive
            cache["state"] = state
            cache["shift_t"] = h[:, -1:].clone()
            cache["shift_c"] = h2[:, -1:].clone()
        return x, cache


def _rwkv_cache(cfg, B, device) -> dict:
    D, H = cfg.d_model, cfg.num_heads
    P = D // H
    return {
        "state": torch.zeros((B, H, P, P), dtype=torch.float32,
                             device=device),
        "shift_t": torch.zeros((B, 1, D), dtype=cfg.dtype, device=device),
        "shift_c": torch.zeros((B, 1, D), dtype=cfg.dtype, device=device),
    }


# --------------------------------------------------------------- registry --

LAYERS = {DENSE: DenseLayer, ENC: DenseLayer, MOE: MoeLayer,
          MAMBA: MambaLayer, MAMBA_SHARED_ATTN: MambaSharedLayer,
          RWKV: RwkvLayer}


def cache_spec(cfg: ModelConfig, spec: LayerSpec, B: int, S_: int,
               device) -> dict:
    """Zero-initialised cache of one layer of the given kind."""
    if spec.kind in (DENSE, ENC, MOE):
        return _attn_cache(cfg, B, S_, device)
    if spec.kind == MAMBA:
        return _mamba_cache(cfg, B, device)
    if spec.kind == RWKV:
        return _rwkv_cache(cfg, B, device)
    if spec.kind == MAMBA_SHARED_ATTN:
        return {"mamba": _mamba_cache(cfg, B, device),
                "shared_attn": _attn_cache(cfg, B, S_, device)}
    raise KeyError(spec.kind)
