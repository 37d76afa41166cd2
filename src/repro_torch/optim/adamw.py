"""AdamW with float32 master weights and bf16 (or the config's) compute
parameters.

Port of ``repro.optim.adamw``.  Parameters, gradients and the state are
dicts keyed by the model's parameter names, in the model's order (the
port's fixed leaf order, as JAX's tree order is its).  Unlike
``torch.optim.AdamW``, the global gradient norm is taken over every leaf
and the gradients are clipped by it inside the update, and weight decay
is decoupled and applied to the float32 master weights; the new compute
parameters are the master weights cast to each parameter's dtype.

JAX's update is pure; the port updates ``master``, ``m`` and ``v`` in
place with ``torch._foreach_*`` (one call per operation over the leaves
of a pass of about ``CHUNK`` values, so that its temporaries stay small
beside a large model's state; elementwise, so the passes give the bits
one call over every leaf gives) and returns the same state dict with
``step`` advanced.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def init_opt_state(params: dict) -> dict:
    """float32 copies of the parameters (``master``), zero ``m`` and
    ``v``, and an int ``step`` of 0."""
    return {
        "master": {n: p.detach().float().clone() for n, p in params.items()},
        "m": {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
              for n, p in params.items()},
        "v": {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
              for n, p in params.items()},
        "step": 0,
    }


def _f32(x) -> float:
    """A Python float holding the float32 rounding of ``x``."""
    return float(torch.as_tensor(x, dtype=torch.float32))


# the values one pass of the update spans: its few float32 temporaries
# (the clipped gradient, the update, its denominator) stay near 1 GB
CHUNK = 1 << 26


def _chunks(leaf_lists, chunk: int):
    """The leaves of parallel lists (same shapes, contiguous but the first
    list's) cut into passes of about ``chunk`` values each: every leaf
    flattened, one larger than ``chunk`` split into slices of ``chunk``,
    then consecutive pieces joined up to ``chunk``.  Yields one list of
    pieces per input list; an in-place operation on a piece writes its
    leaf."""
    flat = [[a.reshape(-1) for a in leaf_lists[0]]] + [
        [a.view(-1) for a in leaves] for leaves in leaf_lists[1:]]
    out, size = [[] for _ in flat], 0
    for i in range(len(flat[0])):
        n = flat[0][i].numel()
        for lo in range(0, n, chunk):
            hi = min(lo + chunk, n)
            if out[0] and size + hi - lo > chunk:
                yield out
                out, size = [[] for _ in flat], 0
            for o, leaves in zip(out, flat):
                o.append(leaves[i][lo:hi])
            size += hi - lo
    if out[0]:
        yield out


def adamw_update(params: dict, grads: dict, opt_state: dict,
                 cfg: AdamWConfig, lr_scale: float = 1.0):
    """One AdamW step.  Returns (new params {name: master cast to the
    parameter's dtype}, the state, the global grad norm before clipping
    as a float32 0-d tensor)."""
    names = list(opt_state["master"])
    step = opt_state["step"] + 1
    g = [grads[n].float() for n in names]
    gsq = torch.stack([x.square().sum() for x in g]).sum()
    gnorm = torch.sqrt(gsq)
    scale = float(torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                              max=1.0))
    f32 = torch.float32
    bc1 = _f32(1 - torch.tensor(cfg.b1, dtype=f32) ** float(step))
    bc2 = _f32(1 - torch.tensor(cfg.b2, dtype=f32) ** float(step))
    lr = _f32(torch.tensor(cfg.lr, dtype=f32) * lr_scale)

    for gs, ws, ms, vs in _chunks([g] + [[opt_state[k][n] for n in names]
                                         for k in ("master", "m", "v")],
                                  CHUNK):
        if scale != 1.0:
            gs = torch._foreach_mul(gs, scale)
        torch._foreach_mul_(ms, cfg.b1)
        torch._foreach_add_(ms, gs, alpha=1 - cfg.b1)
        torch._foreach_mul_(vs, cfg.b2)
        torch._foreach_addcmul_(vs, gs, gs, value=1 - cfg.b2)
        upd = torch._foreach_div(ms, bc1)
        den = torch._foreach_div(vs, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, cfg.eps)
        torch._foreach_div_(upd, den)
        del den, gs
        torch._foreach_add_(upd, ws, alpha=cfg.weight_decay)
        torch._foreach_mul_(upd, lr)
        torch._foreach_sub_(ws, upd)
        del upd

    new_params = {n: opt_state["master"][n].to(params[n].dtype)
                  for n in names}
    opt_state["step"] = step
    return new_params, opt_state, gnorm
