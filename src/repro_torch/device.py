"""Device resolution for the port's entry points, and the device drain
that timed phases end in.

Every entry point (``Cluster``, ``run_experiment``, ``compare_schedulers``,
``train_default_predictor``, ``generate_latency_dataset``, the predictors,
``ResourcePredictor``, ``StreamingDetector``, the motivation experiments)
takes ``device=None``, which means the CUDA card.  Asking for the card on a
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


def sync(device: torch.device) -> None:
    """Wait for the card's queued work (a no-op on the CPU), so a timed
    phase includes its device time."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
