"""The model: embedding, the layers in the JAX scan's order, the logits.

Port of ``repro.models.model`` for serving:

  Model(cfg, device=...)            parameters allocated, not initialised
  model.init_params(generator)      the port's init (JAX's distributions)
  model.init_cache(B, S)            -> Cache
  model(tokens)                     -> logits (B, T, V), the full forward
  model.prefill(tokens, max_seq)    -> (last logits (B, V), Cache)
  model.decode_step(token, cache)   -> (logits (B, V), cache)
  num_params(cfg)                   parameter count, nothing allocated
  active_params(cfg)                parameters a token touches (MoE: k of E)

JAX scans the stacked ``groups`` and then applies the ``tail``; the port
keeps one list in that order (layer ``r * len(pattern) + i``, then the
tail).  ``train_loss`` and ``cross_entropy`` arrive with the training
slice; JAX's sharding collapses to nothing on one card.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn
import torch.nn.functional as F

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
        classes = [Bk.layer_class(s.kind) for s in specs]
        self.cfg = cfg
        self.embed = Bk.new_param((cfg.vocab_size, cfg.d_model), cfg.dtype, dev)
        self.layers = nn.ModuleList(
            [cls(cfg, s, dev) for cls, s in zip(classes, specs)])
        self.shared = (Bk.DenseLayer(cfg, cfg.pattern[-1], dev)
                       if cfg.shared_attn else None)
        self.final_norm = Bk.new_param((cfg.d_model,), torch.float32, dev)
        self.lm_head = (None if cfg.tie_embeddings else
                        Bk.new_param((cfg.d_model, cfg.vocab_size), cfg.dtype,
                                  dev))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> "Model":
        """Random weights from ``generator`` (on the parameters' device)."""
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

    def _run(self, x, mode, cache, start):
        for i, layer in enumerate(self.layers):
            c = None if cache is None else cache.layers[i]
            x, _ = layer(self.cfg, x, mode, c, start, self.shared)
        return x

    def _logits(self, x):
        h = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        return h @ (self.embed.T if self.lm_head is None else self.lm_head)

    @torch.no_grad()
    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """Full forward without a cache: tokens (B, T) -> logits (B, T, V)."""
        return self._logits(self._run(F.embedding(tokens, self.embed), TRAIN,
                                      None, 0))

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, max_seq: int | None = None):
        """tokens (B, T) -> (logits of the last position (B, V), cache).

        The cache holds ``max(max_seq, T)`` positions and is filled in place
        up to T, so decoding continues in it without copying.
        """
        B, T = tokens.shape
        cache = self.init_cache(B, max(max_seq or T, T))
        x = self._run(F.embedding(tokens, self.embed), PREFILL, cache, 0)
        cache.len = T
        return self._logits(x[:, -1:])[:, 0], cache

    @torch.no_grad()
    def decode_step(self, token: torch.Tensor, cache: Cache):
        """token (B, 1) at position ``cache.len`` -> (logits (B, V), cache),
        the cache updated in place."""
        x = self._run(F.embedding(token, self.embed), DECODE, cache,
                      cache.len)
        cache.len += 1
        return self._logits(x)[:, 0], cache


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
