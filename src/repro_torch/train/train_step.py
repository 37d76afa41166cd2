"""Train step: loss -> grad -> (optional int8-compressed gradients) ->
AdamW, with optional microbatch gradient accumulation.

Port of ``repro.train.train_step``.  JAX's step is a pure function of
(params, opt_state, batch); the port's model holds the parameters, so
``step(opt_state, batch)`` differentiates the model's loss with
``torch.autograd.grad``, writes the new parameters into the model in place
and returns (opt_state, metrics).  Microbatch gradients are summed in
float32 in microbatch order and divided by ``accum``, as JAX's scan does;
``compress`` runs the int8 + error-feedback compressor between the
gradients and the optimizer, over JAX's leaves (``jax_leaf_groups``: a
pattern position's layers joined as JAX stacks them), its error state in
``opt_state["comp_err"]``.  Beside the train state (the weights, AdamW's
float32 master, m and v, the carried errors) a step holds the float32
gradients and little else: the microbatches' gradients are added in
place, compression takes a leaf group at a time (a large one in place),
and AdamW works in place in passes, all with the bits of whole-tree
calls.
On a CUDA model the attention forward and backward run in the flash
kernels (``models.attention.attention`` under grad).
"""
from __future__ import annotations

import torch

from repro_torch.models import model as M
from repro_torch.optim import AdamWConfig, adamw_update, lr_schedule
from repro_torch.optim.adamw import init_opt_state
from repro_torch.optim.compress import compress_roundtrip_

_INT_KEYS = ("tokens", "labels", "positions")


def batch_to_device(batch: dict, device) -> dict:
    """A data-pipeline batch (numpy, or tensors) as tensors on ``device``:
    token ids, labels and positions as int64, the rest float32."""
    return {k: torch.as_tensor(v).to(
        device=device, dtype=torch.int64 if k in _INT_KEYS else torch.float32)
        for k, v in batch.items()}


def _split_microbatches(batch: dict, accum: int) -> list[dict]:
    """``accum`` microbatches of consecutive batch rows (positions (3, B,
    S) split along B), as JAX's ``_split_microbatches``."""
    def split(k, x):
        return x.chunk(accum, dim=1 if k == "positions" else 0)

    parts = {k: split(k, v) for k, v in batch.items()}
    return [{k: p[i] for k, p in parts.items()} for i in range(accum)]


def jax_leaf_groups(model: M.Model) -> list[list[str]]:
    """The model's parameter names grouped as JAX's parameter leaves: one
    group per (pattern position, parameter) holding that parameter of
    layers i, i + len(pattern), ... (JAX stacks them over ``repeats``),
    then every other parameter alone, in the model's order."""
    cfg = model.cfg
    n, scanned = len(cfg.pattern), len(cfg.pattern) * cfg.repeats
    groups: dict = {}
    for name, _ in model.named_parameters():
        parts = name.split(".")
        key = name
        if parts[0] == "layers" and int(parts[1]) < scanned:
            key = (int(parts[1]) % n, parts[2])
        groups.setdefault(key, []).append(name)
    return list(groups.values())


def make_train_step(model: M.Model, opt_cfg: AdamWConfig | None = None, *,
                    accum: int = 1, remat: bool = True, compress: bool = False,
                    schedule_kwargs: dict | None = None):
    """Returns step(opt_state, batch) -> (opt_state, metrics), training
    ``model``'s parameters in place; metrics are ``loss``, ``grad_norm``,
    ``lr_scale`` and ``step`` (the optimizer's step after the update)."""
    opt_cfg = opt_cfg or AdamWConfig()
    sk = schedule_kwargs or {}
    model.requires_grad_(True)
    named = dict(model.named_parameters())
    params = list(named.values())
    groups = jax_leaf_groups(model) if compress else None

    def step(opt_state: dict, batch: dict):
        batch = batch_to_device(batch, model.device)
        mbs = [batch] if accum == 1 else _split_microbatches(batch, accum)
        grads, loss = None, None
        for mb in mbs:
            l, _ = M.train_loss(model, mb, remat=remat)
            g = torch.autograd.grad(l, params)
            if grads is None:
                grads = [x.float() for x in g]
                loss = l.detach()
            else:   # a float32 sum of each bf16 value widened, in place
                torch._foreach_add_(grads, list(g))
                loss = loss + l.detach()
            del g, l
        if accum > 1:
            torch._foreach_div_(grads, float(accum))
            loss = loss / accum
        grads = dict(zip(named, grads))
        if compress:   # the gradients and carried errors in place
            opt_state["comp_err"] = compress_roundtrip_(
                grads, opt_state.get("comp_err"), groups)
        lr_scale = lr_schedule(opt_state["step"], **sk)
        new_params, opt_state, gnorm = adamw_update(named, grads, opt_state,
                                                    opt_cfg, lr_scale)
        del grads
        with torch.no_grad():
            for n, p in named.items():
                p.copy_(new_params[n])
        metrics = {"loss": loss, "grad_norm": gnorm, "lr_scale": lr_scale,
                   "step": opt_state["step"]}
        return opt_state, metrics

    return step


def init_train_state(model: M.Model, generator: torch.Generator | None = None,
                     compress: bool = False):
    """(model, opt_state): the model's random init from ``generator`` (none
    keeps its present weights), its parameters made trainable, and AdamW's
    state, with zero carried errors when ``compress``."""
    if generator is not None:
        model.init_params(generator)
    model.requires_grad_(True)
    named = dict(model.named_parameters())
    opt_state = init_opt_state(named)
    if compress:
        opt_state["comp_err"] = {
            n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for n, p in named.items()}
    return model, opt_state
