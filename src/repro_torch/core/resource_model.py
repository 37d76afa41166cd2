"""Resource Prediction Module (paper Section IV-B, Figs. 6-7).

Port of ``repro.core.resource_model``.  QPS -> (CPU cores, MEM GB) is
near-linear per workload type, so one (slope, intercept) pair is kept per
resource per workload type, fitted by least squares in float64 tensors on
the predictor's device.  The samples are float64 from the start (numpy
float64 arrays, or float64 tensors); nothing is widened from float32.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass
class LinearFit:
    slope: float
    intercept: float

    def __call__(self, qps):
        return self.slope * np.asarray(qps, np.float64) + self.intercept


def _f64(a, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor) and a.dtype != torch.float64:
        raise TypeError(f"fit_line takes float64 samples, got {a.dtype}")
    return torch.as_tensor(a, dtype=torch.float64, device=device)


def fit_line(x, y, *, device=None) -> LinearFit:
    """Least-squares line through (x, y), float64 on ``device``."""
    device = resolve_device(device)
    x, y = _f64(x, device), _f64(y, device)
    xm, ym = x.mean(), y.mean()
    cov = ((x - xm) * (y - ym)).mean()
    var = torch.clamp_min(((x - xm) ** 2).mean(), 1e-12)
    slope = cov / var
    out = torch.stack([slope, ym - slope * xm]).cpu()
    return LinearFit(float(out[0]), float(out[1]))


class ResourcePredictor:
    """Predicts pod CPU/MEM demand from (workload_type, qps)."""

    def __init__(self, *, device=None):
        self.device = resolve_device(device)
        self.cpu_fits: dict[str, LinearFit] = {}
        self.mem_fits: dict[str, LinearFit] = {}

    def fit(self, workload_type: str, qps, cpu, mem) -> "ResourcePredictor":
        self.cpu_fits[workload_type] = fit_line(qps, cpu, device=self.device)
        self.mem_fits[workload_type] = fit_line(qps, mem, device=self.device)
        return self

    def predict(self, workload_type: str, qps: float) -> tuple[float, float]:
        """Returns (cpu_cores, mem_gb); clamped to be non-negative."""
        cpu = float(self.cpu_fits[workload_type](qps))
        mem = float(self.mem_fits[workload_type](qps))
        return max(cpu, 0.0), max(mem, 0.0)

    def r2(self, workload_type: str, qps, cpu, mem) -> tuple[float, float]:
        """Goodness of fit, for reproducing Figs. 6-7."""
        out = []
        for fit, y in ((self.cpu_fits[workload_type], cpu),
                       (self.mem_fits[workload_type], mem)):
            pred = fit(qps)
            ss_res = float(((pred - y) ** 2).sum())
            ss_tot = float(((y - np.mean(y)) ** 2).sum())
            out.append(1.0 - ss_res / max(ss_tot, 1e-12))
        return out[0], out[1]
