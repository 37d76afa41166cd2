"""Model input feature vector -- paper Table III (port of
``repro.core.predictors.features``).

Layout (46 features):
  [0]      qps                      -- QPS of the pod being scheduled
  [1:13]   performance metrics      -- cpu util, memory stats, net/disk I/O
  [13:21]  hardware events          -- perf counters
  [21:46]  scheduling-latency stats -- summary of the node's 200-bin runqlat
                                       histogram: avg, p50/p90/p99, total
                                       count, and 20 coarse band masses
"""
from __future__ import annotations

import torch

from repro_torch.core import metric

PERF_METRICS = [
    "cpu_utilization",
    "memory_usage",
    "mem_cache",
    "mem_pgfault",
    "mem_pgmajfault",
    "working_set",
    "memory_rss",
    "net_recv_avg",
    "net_recv_packets_avg",
    "net_send_avg",
    "net_send_packets_avg",
    "disk_io_avg",
]

HARDWARE_EVENTS = [
    "cycles",
    "instructions",
    "cache_references",
    "cache_misses",
    "branch_instructions",
    "branch_misses",
    "context_switches",
    "cpu_migrations",
]

_NUM_BANDS = 20
RUNQLAT_STATS = ["runqlat_avg", "runqlat_p50", "runqlat_p90", "runqlat_p99",
                 "runqlat_count"] + [
    f"runqlat_band_{b}" for b in range(_NUM_BANDS)
]

FEATURE_NAMES = ["qps"] + PERF_METRICS + HARDWARE_EVENTS + RUNQLAT_STATS
NUM_FEATURES = len(FEATURE_NAMES)


def runqlat_summary(hist: torch.Tensor) -> torch.Tensor:
    """(..., 200) histograms -> (..., 25) Table-III stat blocks, float32.

    Batched over every leading dimension, so a whole cluster's node
    histograms are summarised in a handful of launches.  The JAX package
    computes the same statistics in float32 (x64 off); the band masses are
    integer sums divided once, so they round as the JAX values do when its
    float64 features are read back as float32.
    """
    hist = hist.float()
    avg = metric.avg_runqlat(hist)
    p50 = metric.percentile(hist, 50.0)
    p90 = metric.percentile(hist, 90.0)
    p99 = metric.percentile(hist, 99.0)
    total = hist.sum(-1)
    bands = hist.reshape(*hist.shape[:-1], _NUM_BANDS,
                         metric.NUM_BINS // _NUM_BANDS).sum(-1)
    bands = bands / torch.clamp(total, min=1.0)[..., None]
    return torch.cat([torch.stack([avg, p50, p90, p99, total], -1), bands],
                     -1)
