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
place with ``torch._foreach_*`` (one call per operation over every leaf)
and returns the same state dict with ``step`` advanced.
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

    master = [opt_state["master"][n] for n in names]
    m = [opt_state["m"][n] for n in names]
    v = [opt_state["v"][n] for n in names]
    if scale != 1.0:
        g = torch._foreach_mul(g, scale)
    torch._foreach_mul_(m, cfg.b1)
    torch._foreach_add_(m, g, alpha=1 - cfg.b1)
    torch._foreach_mul_(v, cfg.b2)
    torch._foreach_addcmul_(v, g, g, value=1 - cfg.b2)
    mh = torch._foreach_div(m, bc1)
    den = torch._foreach_sqrt(torch._foreach_div(v, bc2))
    torch._foreach_add_(den, cfg.eps)
    upd = torch._foreach_div(mh, den)
    torch._foreach_add_(upd, master, alpha=cfg.weight_decay)
    torch._foreach_mul_(upd, lr)
    torch._foreach_sub_(master, upd)

    new_params = {n: mst.to(params[n].dtype) for n, mst in zip(names,
                                                                master)}
    opt_state["step"] = step
    return new_params, opt_state, gnorm
