"""The model: the input (token embedding or given embeddings), the layers
in the JAX scan's order, the logits.

Port of ``repro.models.model``:

  Model(cfg, device=...)            parameters allocated, not initialised
  model.init_params(generator)      the port's init (JAX's distributions)
  model.init_cache(B, S)            -> Cache
  model(tokens)                     -> logits (B, T, V), the full forward
  model.prefill(tokens, max_seq)    -> (last logits (B, V), Cache)
  model.decode_step(token, cache)   -> (logits (B, V), cache)
  train_loss(model, batch)          -> (loss, metrics), with autograd
  num_params(cfg)                   parameter count, nothing allocated
  active_params(cfg)                parameters a token touches (MoE: k of E)

A config with ``embed_inputs`` (qwen2-vl-72b's patch and token
embeddings, hubert-xlarge's frame embeddings) has no embedding table:
each entry point takes ``embeds=`` (B, T, d_model), cast to ``cfg.dtype``,
in place of token ids, as JAX's batch takes ``"embeds"`` in place of
``"tokens"``.  ``forward`` and ``prefill`` take optional ``positions``
((3, B, T) under M-RoPE, JAX's ``batch["positions"]``); by default and at
decode the positions follow JAX's ``_positions``: ``arange`` from 0, and
at decode the cache length, the same value in all three M-RoPE streams.
That is JAX's rule, not Qwen2-VL's, which would go on from the largest
position of the prompt plus one.  A model with ``causal`` False (the
encoder) attends both ways; its ``decode_step`` is not a meaningful
continuation, as in JAX, which has no decode path for it.

JAX scans the stacked ``groups`` and then applies the ``tail``; the port
keeps one list in that order (layer ``r * len(pattern) + i``, then the
tail).  JAX's sharding collapses to nothing on one card.

Training (JAX's ``train_loss`` and ``cross_entropy``):

  cross_entropy(logits, labels, mask)   token-mean CE, logsumexp in f32
  train_loss(model, batch, remat=True)  -> (loss, {"loss", "tokens"})

``train_loss`` runs the layers in ``TRAIN`` mode with autograd on; with
``remat`` each layer of the repeated pattern runs under
``torch.utils.checkpoint`` (non-reentrant), where JAX puts
``jax.checkpoint`` on each step of its layer scan, so the backward
recomputes the layer's forward (the flash kernel runs twice a layer).
The parameters are frozen (``requires_grad`` False) as the model is
built; ``model.requires_grad_()`` switches them on, as the train step
does.  The encoder's masked-unit loss is the same function over the
batch's ``mask``.  Every layer kind trains on a CUDA model: attention
through ``FlashAttention``, the ``mamba`` / ``mamba_shared_attn`` scans
through ``SSDScan`` and the ``rwkv`` scan through ``WKVScan``, each a
forward and a backward kernel; on the CPU the scans train through their
kernels' plain versions.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import blocks as Bk
from repro_torch.models.blocks import DECODE, PREFILL, TRAIN
from repro_torch.models.common import ModelConfig, init_dense, rms_norm


@dataclasses.dataclass
class Cache:
    """Per-layer caches in layer order, and the filled length (the next
    decode position)."""

    layers: list
    len: int = 0


class Model(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        cfg.validate()
        dev = resolve_device(device)
        specs = cfg.layer_specs()
        self.cfg = cfg
        self.embed = (None if cfg.embed_inputs else
                      Bk.new_param((cfg.vocab_size, cfg.d_model), cfg.dtype,
                                   dev))
        self.layers = nn.ModuleList(
            [Bk.LAYERS[s.kind](cfg, s, dev) for s in specs])
        self.shared = (Bk.DenseLayer(cfg, cfg.pattern[-1], dev)
                       if cfg.shared_attn else None)
        self.final_norm = Bk.new_param((cfg.d_model,), torch.float32, dev)
        # JAX ties the head to the embedding only where there is one
        tied = cfg.tie_embeddings and not cfg.embed_inputs
        self.lm_head = (None if tied else
                        Bk.new_param((cfg.d_model, cfg.vocab_size), cfg.dtype,
                                     dev))

    @property
    def device(self) -> torch.device:
        return self.final_norm.device

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> "Model":
        """Random weights from ``generator`` (on the parameters' device)."""
        if self.embed is not None:
            init_dense(self.embed, generator, in_axis=-1)
        for layer in self.layers:
            layer.init_params(generator)
        if self.shared is not None:
            self.shared.init_params(generator)
        self.final_norm.zero_()
        if self.lm_head is not None:
            init_dense(self.lm_head, generator)
        return self

    def init_cache(self, batch: int, max_seq: int) -> Cache:
        return Cache([Bk.cache_spec(self.cfg, layer.spec, batch, max_seq,
                                    self.device) for layer in self.layers])

    def _embed_in(self, tokens, embeds) -> torch.Tensor:
        """JAX's ``_embed_in``: embeddings cast to ``cfg.dtype`` for an
        ``embed_inputs`` model, else the token ids' rows of the table."""
        cfg = self.cfg
        if cfg.embed_inputs:
            if embeds is None or tokens is not None:
                raise ValueError(f"{cfg.name} takes embeds=, not tokens")
            return embeds.to(cfg.dtype)
        if tokens is None or embeds is not None:
            raise ValueError(f"{cfg.name} takes tokens, not embeds=")
        return F.embedding(tokens, self.embed)

    def _positions(self, x, offset, positions=None) -> torch.Tensor:
        """JAX's ``_positions``: ``offset + arange(T)`` broadcast to (B, T),
        and to all three streams under M-RoPE; given ``positions`` pass
        only under M-RoPE, as JAX reads ``batch["positions"]`` only there."""
        B, T = x.shape[:2]
        if self.cfg.mrope_sections and positions is not None:
            if tuple(positions.shape) != (3, B, T):
                raise ValueError(f"positions {tuple(positions.shape)}, "
                                 f"(3, {B}, {T}) expected")
            return positions
        pos = torch.arange(offset, offset + T, device=self.device)
        pos = pos[None].expand(B, T)
        return pos[None].expand(3, B, T) if self.cfg.mrope_sections else pos

    def _run(self, x, mode, cache, start, pos):
        for i, layer in enumerate(self.layers):
            c = None if cache is None else cache.layers[i]
            x, _ = layer(self.cfg, x, mode, c, start, pos, self.shared)
        return x

    def _logits(self, x):
        h = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        return h @ (self.embed.T if self.lm_head is None else self.lm_head)

    @torch.no_grad()
    def forward(self, tokens: torch.Tensor | None = None, *,
                embeds: torch.Tensor | None = None,
                positions: torch.Tensor | None = None) -> torch.Tensor:
        """Full forward without a cache: tokens (B, T), or ``embeds`` (B, T,
        D), -> logits (B, T, V)."""
        x = self._embed_in(tokens, embeds)
        return self._logits(self._run(x, TRAIN, None, 0,
                                      self._positions(x, 0, positions)))

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor | None = None,
                max_seq: int | None = None, *,
                embeds: torch.Tensor | None = None,
                positions: torch.Tensor | None = None):
        """tokens (B, T), or ``embeds`` (B, T, D), -> (logits of the last
        position (B, V), cache).

        The cache holds ``max(max_seq, T)`` positions and is filled in place
        up to T, so decoding continues in it without copying.
        """
        x = self._embed_in(tokens, embeds)
        B, T = x.shape[:2]
        cache = self.init_cache(B, max(max_seq or T, T))
        x = self._run(x, PREFILL, cache, 0, self._positions(x, 0, positions))
        cache.len = T
        return self._logits(x[:, -1:])[:, 0], cache

    @torch.no_grad()
    def decode_step(self, token: torch.Tensor | None = None,
                    cache: Cache | None = None, *,
                    embeds: torch.Tensor | None = None):
        """token (B, 1), or ``embeds`` (B, 1, D), at position ``cache.len``
        -> (logits (B, V), cache), the cache updated in place."""
        x = self._embed_in(token, embeds)
        x = self._run(x, DECODE, cache, cache.len,
                      self._positions(x, cache.len))
        cache.len += 1
        return self._logits(x)[:, 0], cache


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """Token-mean cross entropy over ``mask`` (JAX's ``cross_entropy``):
    logsumexp in float32, the gold logit gathered, the sum of the masked
    losses over max(mask.sum(), 1)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = (lse - gold) * mask
    return nll.sum() / torch.clamp(mask.sum(), min=1.0)


def train_loss(model: Model, batch: dict, remat: bool = True):
    """batch: ``tokens`` (B, T) or ``embeds`` (B, T, D), ``labels`` (B,
    T), optional ``mask`` (B, T) and ``positions`` (M-RoPE), as tensors on
    the model's device.  Next-token LM loss (causal) or masked-unit
    prediction (the encoder, whose ``mask`` marks predicted frames).
    Returns (loss, {"loss": detached loss, "tokens": mask.sum()})."""
    cfg = model.cfg
    x = model._embed_in(batch.get("tokens"), batch.get("embeds"))
    pos = model._positions(x, 0, batch.get("positions"))
    n_scanned = len(cfg.pattern) * cfg.repeats
    for i, layer in enumerate(model.layers):
        def run(h, layer=layer):
            return layer(cfg, h, TRAIN, None, 0, pos, model.shared)[0]
        x = (checkpoint(run, x, use_reentrant=False)
             if remat and i < n_scanned else run(x))
    logits = model._logits(x)
    labels = batch["labels"]
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=labels.device)
    loss = cross_entropy(logits, labels, mask)
    return loss, {"loss": loss.detach(), "tokens": mask.sum()}


def num_params(cfg: ModelConfig) -> int:
    """Parameter count (the shared block once, every expert), allocating
    nothing."""
    return sum(p.numel() for p in Model(cfg, device="meta").parameters())


def active_params(cfg: ModelConfig) -> int:
    """Parameters touched per token: an MoE layer's ``E - k`` idle experts
    (gate, up and down each) left out, as JAX counts them."""
    total = num_params(cfg)
    if not cfg.num_experts:
        return total
    n_moe = sum(s.kind == "moe" for s in cfg.layer_specs())
    idle = cfg.num_experts - cfg.experts_per_tok
    return total - n_moe * idle * 3 * cfg.d_model * cfg.d_ff
