"""Device resolution for the port's entry points.

Every entry point (``Cluster``, ``run_experiment``, ``compare_schedulers``,
``train_default_predictor``, ``generate_latency_dataset``) takes
``device=None``, which means the CUDA card.  Asking for the card on a
machine without one raises instead of quietly running on the CPU; the CPU
is used only when a caller names it (``device="cpu"``, as the tests do).
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raise when CUDA is asked for but absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU explicitly")
    return dev
