"""Feed-forward: the gated (SwiGLU) MLP.  Port of ``repro.models.ffn``'s
``swiglu``; the MoE arrives with the MoE slice."""
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
