"""Workload profiles for co-located online/offline services.

Online types mirror the paper's CloudSuite picks (Web Serving, Web Search,
Media Streaming, Data Caching) recast as LM-serving services of different
model families; offline types (In-Memory Analytics, Graph Analytics) are
recast as training jobs.  Each profile defines the linear QPS->resource
relation the Resource Prediction Module learns (Figs. 6-7) plus the
latency/thread characteristics driving the contention model.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class OnlineProfile:
    name: str
    type_id: int
    cpu_per_qps: float      # cores per QPS (slope of Fig. 6)
    cpu_base: float         # intercept
    mem_per_qps: float      # GB per QPS (slope of Fig. 7)
    mem_base: float
    base_rt: float          # intrinsic service time, ms
    qps_cap: float          # saturation knee for the service itself
    threads_per_qps: float  # runnable threads generated per unit QPS
    rt_per_runqlat: float   # ms of added response time per latency-unit of runqlat


@dataclasses.dataclass(frozen=True)
class OfflineProfile:
    name: str
    type_id: int
    cores_choices: tuple    # CPU cores a job may request
    mem_per_core: float     # GB per core
    threads_per_core: float # offline jobs oversubscribe threads
    duration_range: tuple   # ticks
    burst_range: tuple = (0.7, 1.7)  # peak/mean CPU pressure ratio: two jobs
                                     # with equal average CPU can exert very
                                     # different run-queue pressure


# type ids: online 0..3, offline 4..5
ONLINE_PROFILES = {
    "web_search": OnlineProfile(
        "web_search", 0, cpu_per_qps=0.022, cpu_base=0.8, mem_per_qps=0.011,
        mem_base=2.0, base_rt=45.0, qps_cap=2200.0, threads_per_qps=0.035,
        rt_per_runqlat=0.105,
    ),
    "web_serving": OnlineProfile(
        "web_serving", 1, cpu_per_qps=0.012, cpu_base=0.5, mem_per_qps=0.006,
        mem_base=1.2, base_rt=18.0, qps_cap=3500.0, threads_per_qps=0.02,
        rt_per_runqlat=0.08,
    ),
    "media_streaming": OnlineProfile(
        "media_streaming", 2, cpu_per_qps=0.03, cpu_base=1.0, mem_per_qps=0.02,
        mem_base=3.0, base_rt=70.0, qps_cap=1400.0, threads_per_qps=0.05,
        rt_per_runqlat=0.13,
    ),
    "data_caching": OnlineProfile(
        "data_caching", 3, cpu_per_qps=0.006, cpu_base=0.3, mem_per_qps=0.016,
        mem_base=4.0, base_rt=4.0, qps_cap=8000.0, threads_per_qps=0.012,
        rt_per_runqlat=0.05,
    ),
}

OFFLINE_PROFILES = {
    "in_memory_analytics": OfflineProfile(
        "in_memory_analytics", 4, cores_choices=(2, 4, 6, 8, 10, 12),
        mem_per_core=2.5, threads_per_core=1.6, duration_range=(300, 1200),
        burst_range=(0.7, 1.7),
    ),
    "graph_analytics": OfflineProfile(
        "graph_analytics", 5, cores_choices=(4, 8, 12, 16),
        mem_per_core=1.8, threads_per_core=2.0, duration_range=(500, 2000),
        burst_range=(0.8, 2.1),
    ),
}

ONLINE_NAMES = list(ONLINE_PROFILES)
OFFLINE_NAMES = list(OFFLINE_PROFILES)
ONLINE_BY_TYPE = {p.type_id: p.name for p in ONLINE_PROFILES.values()}


def online_arrays():
    """Stack online profiles into arrays indexed by type_id (for gathers)."""
    ps = sorted(ONLINE_PROFILES.values(), key=lambda p: p.type_id)
    return {
        "cpu_per_qps": np.array([p.cpu_per_qps for p in ps], np.float32),
        "cpu_base": np.array([p.cpu_base for p in ps], np.float32),
        "mem_per_qps": np.array([p.mem_per_qps for p in ps], np.float32),
        "mem_base": np.array([p.mem_base for p in ps], np.float32),
        "base_rt": np.array([p.base_rt for p in ps], np.float32),
        "qps_cap": np.array([p.qps_cap for p in ps], np.float32),
        "threads_per_qps": np.array([p.threads_per_qps for p in ps], np.float32),
        "rt_per_runqlat": np.array([p.rt_per_runqlat for p in ps], np.float32),
    }


@dataclasses.dataclass
class Pod:
    """A submitted pod: what the user declares + what the Resource
    Prediction Module fills in (cpu_demand / mem_demand)."""

    workload: str
    qps: float              # declared QPS (0 for offline)
    is_online: bool
    cpu_demand: float = 0.0
    mem_demand: float = 0.0
    duration: int = 10_000
    uid: int = -1
