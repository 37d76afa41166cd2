"""Metric-pipeline throughput on the PyTorch port: runqlat histogram
aggregation + Eq. 1/2 evaluation at cluster scale (the collector runs on
every node each tick).  The counterpart of ``bench_metric_pipeline.py``.

``--device`` picks where it runs (default: the CUDA card, timed by CUDA
events; ``--device cpu`` by the host clock); ``--full`` takes 4,000 nodes
instead of 1,000.  Prints ``name,us_per_call,derived`` rows.

    PYTHONPATH=src python benchmarks/bench_torch_metric_pipeline.py --device cpu
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.core import metric
from repro_torch.core.interference import node_interference
from repro_torch.device import resolve_device

SERVICES, SAMPLES = 14, 256   # per node and tick, as the JAX bench


def _us(device, fn, calls):
    """Microseconds per call: CUDA events on the card, the host clock on
    the CPU; one warm-up call first."""
    fn()
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) * 1e3 / calls
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    return (time.perf_counter() - t0) * 1e6 / calls


def run(device=None, full: bool = False) -> dict:
    """The three rows, and the histograms' total beside the samples binned
    (``binned == samples``: every sample lands in one of the 200 bins)."""
    device = resolve_device(device)
    nodes = 4000 if full else 1000
    g = torch.Generator(device=device).manual_seed(0)
    s = torch.rand((nodes, SERVICES, SAMPLES), generator=g,
                   device=device) * 1100.0
    rows = []
    us = _us(device, lambda: metric.histogram(s), 5)
    n = nodes * SERVICES * SAMPLES
    rows.append(("metric.histogram_cluster_tick", us,
                 f"nodes={nodes};samples_per_s={n / (us / 1e6):.3g}"))
    h = metric.histogram(s)
    on, off = h[:, :8], h[:, 8:]
    us = _us(device, lambda: node_interference(on, off), 10)
    rows.append(("metric.node_interference_eq1", us,
                 f"nodes_per_s={nodes / (us / 1e6):.3g}"))
    us = _us(device, lambda: metric.avg_runqlat(h), 10)
    rows.append(("metric.avg_runqlat_eq2", us, f"hists={nodes * SERVICES}"))
    return {"rows": rows, "device": str(device), "nodes": nodes,
            "samples": n, "binned": float(h.sum()),
            "intf": node_interference(on, off), "avg": metric.avg_runqlat(h),
            "hist": h, "input": s}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--full", action="store_true")
    args = ap.parse_args()
    for row in run(args.device, args.full)["rows"]:
        print(",".join(map(str, row)))
