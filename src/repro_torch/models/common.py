"""Shared model machinery: layer specs, the config, RMSNorm and the init.

Port of ``repro.models.common``.  A model is a repeating ``pattern`` of
layer specs applied ``repeats`` times plus a ``tail``; the port keeps the
layers in one list in the JAX scan's order (layer ``r * len(pattern) + i``,
then the tail).  Only the fields the port's code reads are ported: JAX's
``family`` label, its config-level ``rope_theta`` (each layer reads its
spec's) and its lowering knobs (``q_block``, ``kv_block``,
``causal_block_skip``, ``use_pallas``, ``attn_batch_reshard``) are not.
"""
from __future__ import annotations

import dataclasses
import math

import torch

DENSE = "dense"                          # GQA attention + gated MLP
MOE = "moe"                              # GQA attention + mixture of experts
MAMBA = "mamba"                          # Mamba-2 SSD block
MAMBA_SHARED_ATTN = "mamba_shared_attn"  # mamba block + the shared block
RWKV = "rwkv"                            # RWKV-6 time mix + channel mix
ENC = "enc"                              # bidirectional encoder block


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    kind: str
    sliding_window: int = 0     # 0 = full attention
    rope_theta: float = 1e4


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    pattern: tuple = ()          # tuple[LayerSpec, ...]
    repeats: int = 0
    tail: tuple = ()             # tuple[LayerSpec, ...]
    # MoE
    num_experts: int = 0
    experts_per_tok: int = 0
    capacity_factor: float = 1.25
    # "a2a" (JAX: shard_map expert parallelism, which takes the block path
    # on one device) and "block" dispatch per token block; "naive" is one
    # block
    moe_impl: str = "a2a"
    # M-RoPE (qwen2-vl): the hd/2 rotary frequency channels split into
    # (temporal, height, width) sections, each rotated by its own stream
    # of (3, B, S) positions; () is plain RoPE over (B, S) positions
    mrope_sections: tuple = ()
    # SSM
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    shared_attn: bool = False    # zamba2: one attention+MLP block, reused
    causal: bool = True          # False: bidirectional encoder (no decode)
    # the model takes (B, S, d_model) embeddings in place of token ids and
    # has no embedding table (the vision / waveform frontend is a stub)
    embed_inputs: bool = False
    tie_embeddings: bool = False  # lm_head = embed.T (smollm, gemma3)
    norm_eps: float = 1e-6
    dtype: torch.dtype = torch.bfloat16
    # On CUDA tensors, True launches the flash-attention, SSD and WKV
    # kernels and False takes their plain versions; CPU tensors always
    # take the plain versions.
    use_kernels: bool = True

    def validate(self) -> None:
        n = len(self.pattern) * self.repeats + len(self.tail)
        if n != self.num_layers:
            raise ValueError(f"{self.name}: pattern covers {n} layers, "
                             f"expected {self.num_layers}")
        if self.num_heads % self.num_kv_heads:
            raise ValueError(f"{self.name}: {self.num_heads} heads over "
                             f"{self.num_kv_heads} KV heads")

    def layer_specs(self) -> list[LayerSpec]:
        """Every layer's spec in execution order (the JAX scan's order)."""
        return list(self.pattern) * self.repeats + list(self.tail)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in float32 with the ``1 + scale`` form, cast back to x's type."""
    xf = x.float()
    xf = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)
    return (xf * (1.0 + scale.float())).to(x.dtype)


@torch.no_grad()
def init_dense(t: torch.Tensor, generator: torch.Generator,
               in_axis: int = -2, scale: float = 1.0) -> torch.Tensor:
    """Fill ``t`` with the truncated-normal fan-in init, in place.

    Standard normal truncated at +-3, times ``scale / sqrt(fan_in)``; drawn
    in float32 and cast to ``t``'s type, as the JAX init does.
    """
    fan_in = t.shape[in_axis] if t.dim() > 1 else t.shape[0]
    draw = torch.empty(t.shape, dtype=torch.float32, device=t.device)
    torch.nn.init.trunc_normal_(draw, 0.0, 1.0, -3.0, 3.0,
                                generator=generator)
    return t.copy_(draw * (scale / math.sqrt(fan_in)))
