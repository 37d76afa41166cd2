"""GPipe-style pipeline schedule with the stage ring on one device.

Port of ``repro.train.pipeline``.  JAX shards the stacked layers over a
``stage`` mesh axis and passes activations round the ring with
``ppermute`` in the skewed schedule (M + S - 1 ticks for M microbatches
over S stages).  One card has no ring: the port runs the same schedule in
one process, each tick applying every active stage's layer slice to the
microbatch it holds and handing the result to the next stage, and the last
stage emitting microbatch t - (S - 1).  The result equals applying the
layers in order to each microbatch.
"""
from __future__ import annotations

import torch


def gpipe_forward(apply_layer, params_stacked: dict,
                  microbatches: torch.Tensor, *, n_stages: int):
    """Run microbatches through ``n_stages`` pipeline stages.

    apply_layer(layer_params, x) -> x   (one layer)
    params_stacked: dict of tensors with leading dim L, L % n_stages == 0
    microbatches: (M, B, ...) activations
    Returns (M, B, ...) outputs.
    """
    L = next(iter(params_stacked.values())).shape[0]
    if L % n_stages:
        raise ValueError(f"{L} layers do not split into {n_stages} stages")
    per = L // n_stages
    M = microbatches.shape[0]

    def apply_stage(s, x):
        for i in range(s * per, (s + 1) * per):
            x = apply_layer({k: v[i] for k, v in params_stacked.items()}, x)
        return x

    outs = torch.zeros_like(microbatches)
    held = [torch.zeros_like(microbatches[0]) for _ in range(n_stages)]
    for t in range(M + n_stages - 1):
        held[0] = microbatches[min(t, M - 1)]     # stage 0 ingests t
        y = [apply_stage(s, held[s]) if 0 <= t - s < M else held[s]
             for s in range(n_stages)]
        if t >= n_stages - 1:                     # the last stage emits
            outs[t - (n_stages - 1)] = y[-1]
        held = [y[-1]] + y[:-1]                   # stage s -> s + 1
    return outs
