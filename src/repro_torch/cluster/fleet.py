"""Machine-class tables, rack/zone topology and the top-k admission prefilter.

Port of ``repro.cluster.fleet``.  ``MachineClass``, ``Topology``, ``Fleet``
and ``make_fleet`` are host-side tables (numpy, as in the JAX package);
``Fleet.params`` builds the (N,) float32 ``FleetParams`` tensors the tick
reads; ``topk_candidates`` is the admission prefilter on tensors.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.cluster.state import (
    OVERSUB_SLOPE,
    RHO_EPS,
    RUNQLAT_BASE,
    RUNQLAT_SCALE,
    FleetParams,
)

__all__ = [
    "MachineClass", "Topology", "Fleet", "MACHINE_CLASSES", "DEFAULT_MIX",
    "make_fleet", "topk_candidates",
]


@dataclasses.dataclass(frozen=True)
class MachineClass:
    """One machine generation: capacity plus contention physics.  The
    defaults are the paper's testbed node (``std32``)."""

    name: str
    cores: float = 32.0
    mem_gb: float = 64.0
    delay_base: float = RUNQLAT_BASE
    delay_scale: float = RUNQLAT_SCALE
    rho_knee: float = RHO_EPS
    oversub_slope: float = OVERSUB_SLOPE


MACHINE_CLASSES: dict[str, MachineClass] = {
    "std32": MachineClass("std32"),
    "hi96": MachineClass("hi96", cores=96.0, mem_gb=192.0, delay_base=2.7,
                         delay_scale=48.0, rho_knee=0.04,
                         oversub_slope=0.12),
    "lo16": MachineClass("lo16", cores=16.0, mem_gb=32.0, delay_base=3.5,
                         delay_scale=70.0, rho_knee=0.06,
                         oversub_slope=0.22),
    "mem64": MachineClass("mem64", cores=64.0, mem_gb=256.0, delay_base=2.9,
                          delay_scale=52.0, rho_knee=0.05,
                          oversub_slope=0.14),
}

DEFAULT_MIX: dict[str, float] = {"std32": 6, "hi96": 1, "lo16": 3}


@dataclasses.dataclass(frozen=True, eq=False)
class Topology:
    """Rack/zone network with per-link bandwidth (GB/s) and latency (s);
    a transfer runs at its path's bottleneck link."""

    rack_of: np.ndarray        # (N,) int32: node -> rack
    zone_of_rack: np.ndarray   # (R,) int32: rack -> zone
    rack_gbps: float = 25.0
    spine_gbps: float = 10.0
    zone_gbps: float = 4.0
    rack_lat_s: float = 0.0001
    spine_lat_s: float = 0.001
    zone_lat_s: float = 0.004

    @property
    def num_nodes(self) -> int:
        return int(self.rack_of.shape[0])

    def zone_of(self, node: int) -> int:
        return int(self.zone_of_rack[int(self.rack_of[node])])

    def _path(self, src: int, dst: int) -> tuple[float, float]:
        if self.rack_of[src] == self.rack_of[dst]:
            return self.rack_gbps, self.rack_lat_s
        if self.zone_of(src) == self.zone_of(dst):
            return (min(self.rack_gbps, self.spine_gbps),
                    self.rack_lat_s + self.spine_lat_s)
        return (min(self.rack_gbps, self.spine_gbps, self.zone_gbps),
                self.rack_lat_s + self.spine_lat_s + self.zone_lat_s)

    def transfer_cost(self, src: int, dst: int, gb: float) -> float:
        """Seconds to move ``gb`` gigabytes from src to dst (0.0 on-node)."""
        if src == dst:
            return 0.0
        bw, lat = self._path(src, dst)
        return lat + float(gb) / bw

    def cost_factor(self, src: int, dst: int, gb: float) -> float:
        """Transfer cost as a multiple of the same-rack price."""
        if src == dst:
            return 1.0
        ref = self.rack_lat_s + float(gb) / self.rack_gbps
        return self.transfer_cost(src, dst, gb) / ref

    @classmethod
    def regular(cls, num_nodes: int, nodes_per_rack: int = 16,
                racks_per_zone: int = 4, **links) -> "Topology":
        rack_of = np.arange(num_nodes, dtype=np.int32) // nodes_per_rack
        num_racks = int(rack_of[-1]) + 1 if num_nodes else 0
        zone_of_rack = np.arange(num_racks, dtype=np.int32) // racks_per_zone
        return cls(rack_of=rack_of, zone_of_rack=zone_of_rack, **links)

    @classmethod
    def flat(cls, num_nodes: int) -> "Topology":
        return cls.regular(num_nodes, nodes_per_rack=max(num_nodes, 1),
                           racks_per_zone=1)


@dataclasses.dataclass(frozen=True, eq=False)
class Fleet:
    """Per-node machine classes + the network they share."""

    classes: tuple[MachineClass, ...]
    topology: Topology

    def __post_init__(self):
        if len(self.classes) != self.topology.num_nodes:
            raise ValueError(
                f"{len(self.classes)} machine classes for a "
                f"{self.topology.num_nodes}-node topology")

    @property
    def num_nodes(self) -> int:
        return len(self.classes)

    def node_class(self, node: int) -> MachineClass:
        return self.classes[node]

    def class_names(self) -> tuple[str, ...]:
        return tuple(c.name for c in self.classes)

    def cores(self) -> np.ndarray:
        return np.array([c.cores for c in self.classes], np.float64)

    def mem_gb(self) -> np.ndarray:
        return np.array([c.mem_gb for c in self.classes], np.float64)

    def params(self, *, device) -> FleetParams:
        """The (N,) float32 delay-curve tensors the tick reads."""
        def col(attr):
            return torch.tensor([getattr(c, attr) for c in self.classes],
                                dtype=torch.float32, device=device)

        return FleetParams(delay_base=col("delay_base"),
                           delay_scale=col("delay_scale"),
                           rho_knee=col("rho_knee"),
                           oversub_slope=col("oversub_slope"))

    def delay_params64(self) -> dict[str, np.ndarray]:
        """Per-node float64 delay parameters from the MachineClass Python
        floats, never widened from the float32 tensors."""
        return {
            "base": np.array([c.delay_base for c in self.classes],
                             np.float64),
            "scale": np.array([c.delay_scale for c in self.classes],
                              np.float64),
            "knee": np.array([c.rho_knee for c in self.classes], np.float64),
        }

    @classmethod
    def homogeneous(cls, num_nodes: int,
                    machine_class: MachineClass | None = None) -> "Fleet":
        mc = machine_class or MACHINE_CLASSES["std32"]
        return cls(classes=(mc,) * num_nodes,
                   topology=Topology.flat(num_nodes))


def make_fleet(num_nodes: int, mix: dict[str, float] | None = None, *,
               nodes_per_rack: int = 16, racks_per_zone: int = 4,
               seed: int = 0) -> Fleet:
    """Mix machine classes by weight (largest-remainder counts, seeded
    permutation) across a regular rack/zone topology."""
    mix = dict(DEFAULT_MIX if mix is None else mix)
    if not mix:
        raise ValueError("empty machine-class mix")
    unknown = sorted(set(mix) - set(MACHINE_CLASSES))
    if unknown:
        raise ValueError(f"unknown machine classes: {unknown}")
    names = sorted(mix)
    weights = np.array([mix[n] for n in names], np.float64)
    if (weights < 0).any() or weights.sum() <= 0:
        raise ValueError(f"machine-class weights must be >= 0: {mix}")
    exact = weights / weights.sum() * num_nodes
    counts = np.floor(exact).astype(int)
    remainder = exact - counts
    for i in np.argsort(-remainder)[: num_nodes - int(counts.sum())]:
        counts[i] += 1
    pool = [n for name, c in zip(names, counts) for n in [name] * int(c)]
    order = np.random.default_rng(seed).permutation(num_nodes)
    assigned = [""] * num_nodes
    for slot, name in zip(order, pool):
        assigned[int(slot)] = name
    classes = tuple(MACHINE_CLASSES[n] for n in assigned)
    topo = Topology.regular(num_nodes, nodes_per_rack=nodes_per_rack,
                            racks_per_zone=racks_per_zone)
    return Fleet(classes=classes, topology=topo)


def _prefilter_scores(cpu_cur, cpu_sum, mem_cur, mem_sum, cpu_pod, mem_pod,
                      cpu_thr, mem_thr):
    """Negative projected utilization per node (own capacity), -inf where a
    threshold is violated."""
    cpu_proj = (cpu_cur + cpu_pod) / cpu_sum
    mem_proj = (mem_cur + mem_pod) / mem_sum
    feasible = (cpu_proj <= cpu_thr) & (mem_proj <= mem_thr)
    score = -torch.maximum(cpu_proj, mem_proj)
    return torch.where(feasible, score, -torch.inf)


def topk_candidates(cpu_cur, cpu_sum, mem_cur, mem_sum, cpu_pod, mem_pod,
                    cpu_thr, mem_thr, k: int):
    """The k best nodes by the prefilter and their scores.

    Ties go to the lowest index, as with ``jax.lax.top_k``: on an empty
    cluster every node of a class ties exactly, and ``torch.topk`` on CUDA
    promises no order, so this takes a stable descending sort.
    """
    scores = _prefilter_scores(cpu_cur, cpu_sum, mem_cur, mem_sum, cpu_pod,
                               mem_pod, cpu_thr, mem_thr)
    vals, idx = torch.sort(scores, descending=True, stable=True)
    return idx[:k], vals[:k]
