"""Scheduler decision latency at scale on the PyTorch port: Algorithm 1 is
on every pod submission's critical path, so it must stay cheap as the
node count grows.

The port's counterpart of ``bench_scheduler_latency``, with the same views,
schedulers and row names (prefixed ``torch.``).  The sweep runs every
scheduler against heterogeneous ``make_fleet`` views of 128 / 1,000 nodes
(and 5,000 with ``--full``, 40 repetitions instead of 20) and reports mean
and p99 admission latency.  Past ``SchedulerConfig.candidate_k`` (64)
nodes ICO and ICO-F score through the top-k prefilter, so their rows are
the sub-linear evidence JAX's CI gates on (the 5,000-node p99 within 10x
of the 128-node p99); HUP, LQP and RR score all N nodes, the linear
contrast.  Each sample is host clock around ``select_node``, which ends in
``int(best)``: a host read that waits for the device's work, so on the
card a sample is what a caller waits for.  One untimed call first pays
the first launches and the library set-up.

``--timers`` runs a short proactive control loop against a live 8-node
cluster (30 windows of 40 ticks) and reports the loop's ``PhaseTimers``
split (rollout / snapshot / detect / forecast / plan / verify).  The
``rollout.python`` and ``rollout.scanned`` rows time one window through
``Cluster.rollout`` and ``Cluster.rollout_scan``: in the port these are
one path (``rollout_scan`` calls ``rollout``; capturing it in a CUDA graph
is later work), so both rows carry ``same_path=True`` and there is no
speedup row.

``--json [PATH]`` dumps ``{"rows": ..., "sweep": {scheduler: {n: {mean_us,
p99_us}}}}``.  ``--device`` picks where the port runs (default: the CUDA
card; ``--device cpu`` the CPU).

    PYTHONPATH=src python benchmarks/bench_torch_scheduler_latency.py --device cpu
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.cluster.fleet import make_fleet
from repro_torch.cluster.view import ClusterView
from repro_torch.cluster.workloads import Pod
from repro_torch.core import (
    HUPScheduler,
    ICOFScheduler,
    ICOScheduler,
    InterferenceQuantifier,
    LQPScheduler,
    RoundRobinScheduler,
)
from repro_torch.device import resolve_device, sync

SIZES_FAST = (128, 1000)
SIZES_FULL = (128, 1000, 5000)


def _fleet_view(n: int, seed: int = 0, *, device) -> ClusterView:
    """A heterogeneous admission snapshot: per-class capacities and delay
    params from ``make_fleet``, synthetic occupancy at ~5-60% so every node
    stays feasible and the argmax does real work.  The same numpy draws as
    JAX's bench; telemetry as float32 tensors on ``device``, the delay
    params float64 numpy."""
    fleet = make_fleet(n, seed=seed)
    rng = np.random.default_rng(seed)
    cores, mem = fleet.cores(), fleet.mem_gb()
    hists = np.zeros((n, 4, 200))
    hists[:, :, 20] = rng.integers(1, 50, (n, 4))
    d64 = fleet.delay_params64()
    cpu_cur = rng.uniform(0.05, 0.55, n) * cores
    mem_cur = rng.uniform(0.05, 0.55, n) * mem
    features = rng.normal(0, 1, (n, 45))
    qps_sum = rng.uniform(0, 500, n)

    def t(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float32), device=device)

    return ClusterView(
        cpu_cur=t(cpu_cur), cpu_sum=t(cores), mem_cur=t(mem_cur),
        mem_sum=t(mem), online_hists=t(hists),
        offline_hists=t(np.zeros((n, 4, 200))), features=t(features),
        online_qps_sum=t(qps_sum), node_class=fleet.class_names(),
        fleet=fleet, delay_base=d64["base"], delay_scale=d64["scale"],
        rho_knee=d64["knee"],
    )


def _quantifier():
    # a light linear predictor keeps this a scheduler-cost benchmark
    return InterferenceQuantifier(lambda x: x[:, 0] * 0.1)


def _schedulers():
    q = _quantifier()
    return {
        "ICO": ICOScheduler(q),
        "ICO-F": ICOFScheduler(q),
        "HUP": HUPScheduler(q),
        "LQP": LQPScheduler(),
        "RR": RoundRobinScheduler(),
    }


def _pod() -> Pod:
    pod = Pod("web_search", 200.0, True)
    pod.cpu_demand, pod.mem_demand = 4.0, 3.0
    return pod


def sweep(sizes, reps: int, *, device, out=None) -> dict:
    """``{scheduler: {str(n): {mean_us, p99_us, selected}}}`` over
    ``sizes``; ``out`` receives the rows."""
    result: dict[str, dict[str, dict]] = {}
    pod = _pod()
    for n in sizes:
        view = _fleet_view(n, device=device)
        for name, sched in _schedulers().items():
            sched.select_node(pod, view)  # warm: first launches, set-up
            lat = np.empty(reps)
            for r in range(reps):
                t0 = time.perf_counter()
                sel = sched.select_node(pod, view)
                lat[r] = time.perf_counter() - t0
            mean_us = float(lat.mean() * 1e6)
            p99_us = float(np.percentile(lat, 99) * 1e6)
            result.setdefault(name, {})[str(n)] = {
                "mean_us": mean_us, "p99_us": p99_us, "selected": int(sel)}
            if out is not None:
                out.append((f"torch.scheduler_latency.{name}.n{n}", mean_us,
                            f"p99_us={p99_us:.1f};selected={sel}"))
    return result


def phase_timers(out, *, device, windows: int = 30, window_ticks: int = 40,
                 reps: int = 10) -> dict:
    """Per-phase wall-clock split of a live proactive control loop on a
    small real cluster (8 nodes, ten online pods), as JAX's bench drives
    it; returns ``{"rollout_ms": {...}, "phases": loop summary}``."""
    from repro_torch.cluster.simulator import Cluster
    from repro_torch.cluster.workloads import ONLINE_PROFILES
    from repro_torch.control import ControlLoop, scheduler_loop_config

    q = _quantifier()
    sched = ICOScheduler(q)
    cluster = Cluster(num_nodes=8, seed=5, device=device)
    cluster.rollout(30)
    rng = np.random.default_rng(5)
    for _ in range(10):
        name = rng.choice(list(ONLINE_PROFILES))
        prof = ONLINE_PROFILES[name]
        qps = float(rng.uniform(150, 450))
        pod = Pod(name, qps, True)
        pod.cpu_demand = prof.cpu_per_qps * qps + prof.cpu_base
        pod.mem_demand = prof.mem_per_qps * qps + prof.mem_base
        node = sched.select_node(pod, cluster.view())
        if node >= 0:
            cluster.place(pod, node)
        cluster.rollout(10)
    # one window through each entry after a warm call; the two are one
    # path in the port, so the rows are two samples of it
    rollout_ms = {}
    for label, roll in (("python", cluster.rollout),
                        ("scanned", cluster.rollout_scan)):
        roll(window_ticks)
        sync(device)
        t0 = time.perf_counter()
        for _ in range(reps):
            roll(window_ticks)
        sync(device)
        rollout_ms[label] = (time.perf_counter() - t0) / reps * 1e3
        out.append((
            f"torch.scheduler_latency.rollout.{label}",
            rollout_ms[label] * 1e3,
            f"reps={reps};mean_ms={rollout_ms[label]:.2f};same_path=True",
        ))

    loop = ControlLoop(q, scheduler_loop_config("ICO", proactive=True))
    for _ in range(windows):
        with loop.timers.phase("rollout"):
            cluster.rollout_scan(window_ticks)
            sync(device)
        loop.step(cluster)
    summary = loop.timers.summary()
    for phase, s in sorted(summary.items()):
        out.append((
            f"torch.scheduler_latency.phase.{phase}",
            s["mean_ms"] * 1e3,  # us, like every other row
            f"calls={s['calls']};total_s={s['total_s']:.3f};"
            f"mean_ms={s['mean_ms']:.2f}",
        ))
    return {"rollout_ms": rollout_ms, "phases": summary}


def run(fast: bool = True, timers: bool = False,
        sweep_out: dict | None = None, *, device=None) -> list:
    device = resolve_device(device)
    out: list = []
    result = sweep(SIZES_FAST if fast else SIZES_FULL, 20 if fast else 40,
                   device=device, out=out)
    if sweep_out is not None:
        sweep_out.update({name: {n: {k: v[k] for k in ("mean_us", "p99_us")}
                                 for n, v in by_n.items()}
                          for name, by_n in result.items()})
    if timers:
        phase_timers(out, device=device)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--full", action="store_true",
                    help="add 5,000 nodes, 40 repetitions")
    ap.add_argument("--timers", action="store_true",
                    help="add the control loop's phase split")
    ap.add_argument("--json", nargs="?",
                    const="BENCH_torch_scheduler_latency.json", default=None,
                    help="dump the rows and the sweep as JSON")
    args = ap.parse_args()
    sweep_doc: dict = {}
    rows = run(fast=not args.full, timers=args.timers, sweep_out=sweep_doc,
               device=args.device)
    print("name,us_per_call,derived")
    for name, us, derived in rows:
        print(f"{name},{us:.1f},{derived}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"rows": [list(r) for r in rows], "sweep": sweep_doc},
                      f, indent=2)
        print(f"wrote {args.json}")


if __name__ == "__main__":
    main()
