"""Feed-forward layers: the gated (SwiGLU) MLP and the capacity-based MoE.

Port of ``repro.models.ffn``.  The MoE is token-choice top-k routing with a
per-(token block, expert) capacity and dropped-token overflow, dispatched
into an (blocks, E * capacity, D) buffer, each expert's SwiGLU run as one
batched product over its rows, and combined with the gate weights.  JAX
computes it in plain jnp (no Pallas kernel), so the port computes it in
plain torch: the same routing (same experts, positions and drops), the
buffer filled with ``index_add_`` and read back with a gather.

``moe_ffn_a2a`` (JAX's shard_map expert parallelism, the default
``moe_impl="a2a"`` on a mesh) is not ported: on one device JAX's MoE layer
takes ``moe_ffn``'s block path, and so does the port's on its one card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """x: (B, T, D); weights in JAX's (in, out) layout."""
    g = x @ w_gate
    u = x @ w_up
    h = F.silu(g.float()).to(x.dtype) * u
    return h @ w_down


NUM_TOKEN_BLOCKS = 32  # JAX's: divides every assigned global batch x seq


def _num_blocks(N: int) -> int:
    nb = min(NUM_TOKEN_BLOCKS, N)
    while N % nb:
        nb -= 1
    return nb


def top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last axis: the k largest in descending
    order, ties to the lower index (a stable sort keeps the index order
    among equal values)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_route(x: torch.Tensor, router: torch.Tensor, *, experts_per_tok: int,
              capacity_factor: float = 1.25,
              block_dispatch: bool = True) -> dict:
    """The routing of ``moe_ffn``, as JAX computes it.

    x: (B, T, D) -> ``NB`` token blocks of ``Nb`` tokens, the capacity
    ``cap`` of each (block, expert), router ``logits`` (NB, Nb, E) in
    float32, and per (block, token, slot): ``expert_idx``, ``pos`` (the
    slot's place in its expert's rows of the block, counted in token-major
    (token, slot) order), ``keep`` (pos < cap) and ``gate`` (the top-k
    probabilities renormalised, 0 where dropped)."""
    B, T, D = x.shape
    E = router.shape[1]
    N = B * T
    k = experts_per_tok
    NB = _num_blocks(N) if block_dispatch else 1
    Nb = N // NB
    cap = max(1, int(capacity_factor * Nb * k / E))
    logits = x.reshape(NB, Nb, D).float() @ router.float()
    gate, expert_idx = top_k(torch.softmax(logits, dim=-1), k)
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    onehot = F.one_hot(expert_idx, E).reshape(NB, Nb * k, E)
    pos = ((onehot.cumsum(1) - onehot) * onehot).sum(-1).reshape(NB, Nb, k)
    keep = pos < cap
    return dict(NB=NB, Nb=Nb, cap=cap, logits=logits, expert_idx=expert_idx,
                pos=pos, keep=keep, gate=torch.where(keep, gate, 0.0))


def moe_ffn(x: torch.Tensor, router: torch.Tensor, w_gate: torch.Tensor,
            w_up: torch.Tensor, w_down: torch.Tensor, *, experts_per_tok: int,
            capacity_factor: float = 1.25,
            block_dispatch: bool = True) -> torch.Tensor:
    """Top-k token-choice MoE with capacity: x (B, T, D) -> (B, T, D).

    router (D, E) float32; w_gate, w_up (E, D, F); w_down (E, F, D).  With
    ``block_dispatch`` the tokens form JAX's ``_num_blocks`` blocks with a
    capacity per (block, expert); without, one block."""
    B, T, D = x.shape
    E = router.shape[1]
    k = experts_per_tok
    r = moe_route(x, router, experts_per_tok=k,
                  capacity_factor=capacity_factor,
                  block_dispatch=block_dispatch)
    NB, Nb, cap, keep = r["NB"], r["Nb"], r["cap"], r["keep"]
    # the flat row of each (block, token, slot) in the dispatch buffer
    slot = r["expert_idx"] * cap + r["pos"].clamp_max(cap - 1)
    row = (slot + torch.arange(NB, device=x.device)[:, None, None]
           * (E * cap)).reshape(-1)
    src = torch.where(keep[..., None], x.reshape(NB, Nb, 1, D), 0)
    buf = torch.zeros((NB * E * cap, D), dtype=x.dtype, device=x.device)
    buf.index_add_(0, row, src.reshape(-1, D))
    # every expert's rows of every block, one batched product per weight
    xe = buf.reshape(NB, E, cap, D).transpose(0, 1).reshape(E, NB * cap, D)
    h = F.silu(torch.bmm(xe, w_gate).float()).to(x.dtype) * torch.bmm(xe,
                                                                       w_up)
    out = torch.bmm(h, w_down).reshape(E, NB, cap, D).transpose(0, 1)
    picked = out.reshape(NB * E * cap, D)[row].reshape(NB, Nb, k, D)
    combined = (picked.float() * r["gate"][..., None]).sum(2)
    return combined.reshape(B, T, D).to(x.dtype)


def moe_aux_loss(logits: torch.Tensor, expert_idx: torch.Tensor,
                 num_experts: int) -> torch.Tensor:
    """Load-balancing auxiliary loss (Switch-style): logits (N, E), the
    tokens' experts (N, k) of which the first slot counts."""
    me = torch.softmax(logits, dim=-1).mean(0)
    ce = F.one_hot(expert_idx[:, 0], num_experts).float().mean(0)
    return num_experts * (me * ce).sum()
