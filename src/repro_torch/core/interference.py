"""Interference quantification -- Eqs. (1) and (3) of the paper.

Port of ``repro.core.interference``:

    intf_h = w_a * sum_{i in online} avg(runqlat^i)
           + w_b * sum_{j in offline} avg(runqlat^j)            (1)
    intf_p = w_c * model(qps_pod, data_node)                     (3)

Both are normalised by the histogram range (995 latency units == 1.0), as
in the JAX package.  Eq. (1) is float32; Eq. (3) is returned in float64,
the precision the JAX package's numpy post-processing gives it.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core import metric

INTF_NORM = 1.0 / metric.OVERFLOW_EDGE


@dataclasses.dataclass(frozen=True)
class InterferenceWeights:
    """Paper weights: w_a, w_b > 1 (Eq. 1); w_c > 0 (Eq. 3)."""

    w_a: float = 2.0
    w_b: float = 1.2
    w_c: float = 1.0

    def __post_init__(self):
        if not (self.w_a > 1.0 and self.w_b > 1.0):
            raise ValueError("paper requires w_a, w_b > 1")
        if not self.w_c > 0.0:
            raise ValueError("paper requires w_c > 0")


def node_interference(online_hists: torch.Tensor,
                      offline_hists: torch.Tensor, w_a: float = 2.0,
                      w_b: float = 1.2) -> torch.Tensor:
    """Eq. (1) over nodes: (..., n_on, 200), (..., n_off, 200) -> (...,).

    Absent services are all-zero histograms, which avg() maps to 0.
    """
    on = metric.avg_runqlat(online_hists).sum(-1)
    off = metric.avg_runqlat(offline_hists).sum(-1)
    return (w_a * on + w_b * off) * INTF_NORM


def pod_interference(predictor: Callable, qps_pod: float,
                     node_features: torch.Tensor,
                     w_c: float = 1.0) -> torch.Tensor:
    """Eq. (3) for a pod against one (F,) or many (N, F) nodes.

    ``node_features`` is the Table-III layout WITHOUT the leading QPS
    column, which is prepended here.  Returns float64, shape () or (N,).
    """
    feats = torch.as_tensor(node_features, dtype=torch.float32)
    single = feats.dim() == 1
    if single:
        feats = feats[None, :]
    qps_col = torch.full((feats.shape[0], 1), float(qps_pod),
                         dtype=torch.float32, device=feats.device)
    x = torch.cat([qps_col, feats], dim=1)
    pred = predictor(x).double().reshape(-1)
    out = w_c * torch.clamp(pred, min=0.0) * INTF_NORM
    return out[0] if single else out


@dataclasses.dataclass
class InterferenceQuantifier:
    """The Interference Quantification Module (Section IV-D): Eq. (1) on
    the node side, Eq. (3) through a trained predictor on the pod side."""

    predictor: Callable
    weights: InterferenceWeights = dataclasses.field(
        default_factory=InterferenceWeights)

    def intf_nodes(self, online_hists, offline_hists) -> torch.Tensor:
        return node_interference(online_hists, offline_hists,
                                 self.weights.w_a, self.weights.w_b)

    def intf_pod(self, qps_pod: float, node_features) -> torch.Tensor:
        return pod_interference(self.predictor, qps_pod, node_features,
                                self.weights.w_c)
