"""One MoE routing held across the runs a check compares.

Two runs of an MoE model that should agree (the kernel path against the
plain path, prefill + decode against the full forward) differ by an ulp
in the router's input, and an ulp can move a near tie of the top-k: a
token routed to other experts changes its output by far more than any
tolerance that would still test the rest.  ``PinnedRouting`` holds the
runs to one routing and counts the tokens it moved.

It keys each recorded routing by the layer's router parameter, not by the
order of the calls: ``train_loss`` checkpoints every scanned layer, so the
backward recomputes each layer's forward, last layer first, and a replay
by call order would hand each recompute another layer's experts.

The JAX package has no counterpart: this is a tool of the port's checks.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import ffn


class PinnedRouting:
    """While active, ``ffn.moe_route`` records the experts of the first
    call with each router, by token, (B, T, k).  Every later call with that
    router, in this run (a recompute) or another, routes its tokens to the
    experts recorded for them (``select`` picks the recorded tokens a call
    sees, all of them by default), recomputes gates, positions and drops
    for those experts as ``moe_route`` computes them, and counts in
    ``differ`` the tokens whose own top-k set differs (``tokens``: the
    tokens so routed).  After ``replay(select)`` nothing new is recorded:
    a router without a recorded routing raises."""

    def __init__(self):
        self.real = ffn.moe_route
        self.recorded: dict = {}
        self.recording, self.select = True, None
        self.differ, self.tokens = 0, 0

    def __enter__(self):
        ffn.moe_route = self.route
        return self

    def __exit__(self, *exc):
        ffn.moe_route = self.real

    def replay(self, select=None):
        self.recording, self.select = False, select

    def route(self, x, router, **kw):
        r = self.real(x, router, **kw)
        B, T = x.shape[:2]
        key = router.data_ptr()
        if key in self.recorded:
            idx = self.recorded[key]
            if self.select is not None:
                idx = self.select(idx)
            idx = idx.reshape(r["expert_idx"].shape)
            own = r["expert_idx"].sort(-1).values != idx.sort(-1).values
            self.differ += int(own.any(-1).sum())
            self.tokens += B * T
        elif self.recording:
            idx = r["expert_idx"]
            self.recorded[key] = idx.reshape(B, T, -1)
        else:
            raise KeyError("no routing recorded for this router")
        # the recorded call too takes its gates from this graph, not from
        # moe_route's: a checkpoint's recompute must save what its forward
        # saved (the same values: gathered where moe_route sorts)
        probs = torch.softmax(r["logits"], dim=-1)
        gate = probs.gather(-1, idx)
        gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
        NB, Nb, k = idx.shape
        oh = F.one_hot(idx, probs.shape[-1]).reshape(NB, Nb * k, -1)
        pos = ((oh.cumsum(1) - oh) * oh).sum(-1).reshape(NB, Nb, k)
        keep = pos < r["cap"]
        return dict(r, expert_idx=idx, pos=pos, keep=keep,
                    gate=torch.where(keep, gate, 0.0))
