"""Scheduling-latency (runqlat) metric: the paper's 200x5 histogram and Eq. 2.

Port of ``repro.core.metric``.  Bin k counts latencies in [5k, 5k+5); bin
199 is the overflow bin (>= 995 latency units).  Eq. (2):

    avg(runqlat) = ( sum_k runqlat_k * k * 5 ) / ( sum_k runqlat_k )

Every function takes tensors and works on any leading batch dimensions.
``histogram`` bins through the ``runqlat_hist`` kernel wrapper, which runs
the CUDA kernel for a CUDA tensor and its plain version for a CPU tensor.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels.runqlat_hist import BIN_WIDTH, NUM_BINS, runqlat_hist

OVERFLOW_EDGE = BIN_WIDTH * (NUM_BINS - 1)  # 995: samples >= this land in 199


def histogram(samples: torch.Tensor,
              weights: torch.Tensor | None = None) -> torch.Tensor:
    """Bin (..., S) float32 latency samples into (..., 200) float32 counts.

    Negative samples clamp to bin 0, samples >= 995 go to bin 199.
    ``weights`` (..., S) scales each sample (zero masks padding).
    """
    lead, s = samples.shape[:-1], samples.shape[-1]
    flat = samples.reshape(-1, s).contiguous()
    w = None if weights is None else weights.reshape(-1, s).contiguous()
    return runqlat_hist(flat, w).reshape(*lead, NUM_BINS)


def avg_runqlat(hist: torch.Tensor) -> torch.Tensor:
    """Eq. (2): (..., 200) counts -> (...,) averages; empty histograms -> 0.

    Bin k contributes weight k*5 (its left edge), as in the paper.
    """
    hist = hist.float()
    k = torch.arange(NUM_BINS, dtype=torch.float32, device=hist.device)
    num = (hist * (k * BIN_WIDTH)).sum(-1)
    den = hist.sum(-1)
    return torch.where(den > 0, num / torch.clamp(den, min=1e-12), 0.0)


def merge(*hists: torch.Tensor) -> torch.Tensor:
    """Merge histograms (counts are additive)."""
    out = hists[0]
    for h in hists[1:]:
        out = out + h
    return out


def percentile(hist: torch.Tensor, q: float) -> torch.Tensor:
    """Approximate q-th percentile (0..100) from the histogram (left edge)."""
    hist = hist.float()
    total = hist.sum(-1, keepdim=True)
    cdf = torch.cumsum(hist, -1) / torch.clamp(total, min=1e-12)
    # argmax of the first bin past q; CUDA argmax takes no bool, so cast
    k = torch.argmax((cdf >= (q / 100.0)).to(torch.int32), dim=-1)
    return k.float() * BIN_WIDTH


@dataclasses.dataclass
class RunqlatCollector:
    """Streaming collector: accumulates samples into the 200-bin histogram
    (the framework-side analogue of the paper's eBPF collector)."""

    hist: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(NUM_BINS, dtype=np.float64)
    )
    count: int = 0

    def add(self, samples) -> None:
        samples = np.asarray(samples, dtype=np.float64).ravel()
        if samples.size == 0:
            return
        idx = np.clip((samples // BIN_WIDTH).astype(np.int64), 0, NUM_BINS - 1)
        np.add.at(self.hist, idx, 1.0)
        self.count += samples.size

    def average(self) -> float:
        return float(avg_runqlat(torch.as_tensor(self.hist,
                                                 dtype=torch.float32)))

    def snapshot(self) -> np.ndarray:
        return self.hist.copy()

    def reset(self) -> None:
        self.hist[:] = 0.0
        self.count = 0


def sample_from_hist(hist: torch.Tensor, generator: torch.Generator,
                     num_samples: int) -> torch.Tensor:
    """Draw latency samples consistent with a histogram (simulation replay).

    Bins are drawn by their mass, then jittered uniformly inside the bin.
    """
    hist = hist.float()
    probs = hist / torch.clamp(hist.sum(), min=1e-12)
    bins = torch.multinomial(probs, num_samples, replacement=True,
                             generator=generator)
    jitter = torch.rand(num_samples, generator=generator,
                        device=hist.device) * BIN_WIDTH
    return bins.float() * BIN_WIDTH + jitter
