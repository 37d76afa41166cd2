"""End-to-end scheduler comparison -- reproduces Figs. 13-15.

Port of ``repro.cluster.experiment`` (without the control plane, the
forecast service and the trace recorder, which later slices bring): runs
identical pod-arrival traces under ICO / RR / HUP / LQP and reports online
avg/p90/p99 response time plus cross-node CPU/MEM utilization spread.
Rejected pods wait in a bounded retry queue, per Algorithm 1.

The simulation runs on the cluster's device; response-time samples stay
there until the end of the run, when the statistics are taken on the host
with numpy exactly as the JAX driver takes them.
"""
from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np
import torch

from repro_torch.cluster import workloads as W
from repro_torch.cluster.dataset import _random_pod, generate_latency_dataset
from repro_torch.cluster.simulator import Cluster
from repro_torch.cluster.state import TICKS_PER_DAY
from repro_torch.cluster.workloads import Pod
from repro_torch.core import (
    HUPScheduler,
    ICOScheduler,
    InterferenceQuantifier,
    LQPScheduler,
    RoundRobinScheduler,
    SchedulerConfig,
)
from repro_torch.core.predictors import RandomForestRegressor
from repro_torch.device import resolve_device


@dataclasses.dataclass
class ExperimentResult:
    scheduler: str
    avg_rt: float
    p90_rt: float
    p99_rt: float
    cpu_util_std: float
    mem_util_std: float
    placed: int
    rejected: int
    queued_retries: int = 0   # placements that succeeded via the retry queue


def train_default_predictor(seed: int = 0, num_placements: int = 250, *,
                            device=None):
    """Train the production Random Forest used by Eq. (3)."""
    device = resolve_device(device)
    X, y = generate_latency_dataset(num_placements=num_placements, seed=seed,
                                    device=device)
    return RandomForestRegressor(n_estimators=30, max_depth=10, seed=seed,
                                 device=device).fit(X, y)


def make_schedulers(predictor, cfg: SchedulerConfig | None = None):
    """The Figs. 13-15 scheduler set."""
    cfg = cfg or SchedulerConfig()
    q = InterferenceQuantifier(predictor.predict)
    return {
        "ICO": ICOScheduler(q, cfg),
        "RR": RoundRobinScheduler(cfg),
        "HUP": HUPScheduler(q, cfg),
        "LQP": LQPScheduler(cfg),
    }


def _arrival_trace(num_pods: int, seed: int):
    """Pre-generate an identical pod sequence for every scheduler."""
    rng = np.random.default_rng(seed)
    pods, gaps = [], []
    for _ in range(num_pods):
        pods.append(_random_pod(rng))
        gaps.append(int(rng.integers(5, 25)))  # ticks between submissions
    return pods, gaps


def bursty_trace(
    num_online: int = 24,
    num_bursts: int = 5,
    jobs_per_burst: int = 4,
    seed: int = 0,
    burst_gap: tuple = (30, 60),
    job_duration: tuple = (120, 240),
    days: float | None = None,
):
    """A stable online fleet, then recurring waves of heavy short offline
    jobs (the runtime-mitigation scenario).  ``days`` raises
    ``num_bursts`` until the expected span covers that many diurnal
    periods."""
    rng = np.random.default_rng(seed)
    if days is not None:
        online_span = num_online * 5.0          # mean of the (3, 8) gaps
        per_burst = 2 * (jobs_per_burst - 1) + sum(burst_gap) / 2.0
        num_bursts = max(num_bursts, int(round(
            (days * TICKS_PER_DAY - online_span) / per_burst)))
    pods, gaps = [], []
    for _ in range(num_online):
        name = rng.choice(W.ONLINE_NAMES)
        prof = W.ONLINE_PROFILES[name]
        qps = float(rng.uniform(120, 500))
        pod = Pod(name, qps, True)
        pod.cpu_demand = prof.cpu_per_qps * qps + prof.cpu_base
        pod.mem_demand = prof.mem_per_qps * qps + prof.mem_base
        pods.append(pod)
        gaps.append(int(rng.integers(3, 8)))
    for _ in range(num_bursts):
        for j in range(jobs_per_burst):
            name = rng.choice(W.OFFLINE_NAMES)
            prof = W.OFFLINE_PROFILES[name]
            cores = float(prof.cores_choices[-2])
            pod = Pod(name, 0.0, False,
                      duration=int(rng.integers(*job_duration)))
            pod.cpu_demand = cores
            pod.mem_demand = cores * prof.mem_per_core
            pods.append(pod)
            gaps.append(2 if j < jobs_per_burst - 1
                        else int(rng.integers(*burst_gap)))
    return pods, gaps


def run_experiment(
    scheduler,
    pods: list[Pod],
    gaps: list[int],
    num_nodes: int = 12,
    seed: int = 7,
    settle_ticks: int = 40,
    *,
    fleet=None,
    retry_limit: int = 8,
    retry_attempts: int = 3,
    recorder=None,
    device=None,
    noise=None,
) -> ExperimentResult:
    """Replay one arrival trace under a scheduler.

    fleet: optional ``repro_torch.cluster.fleet.Fleet``; when given it
        defines the node population and ``num_nodes`` is taken from it.
    retry_limit / retry_attempts: Algorithm 1's bounded retry queue.
    recorder: trace recording is not ported yet; passing one raises.
    device: where the simulation runs (``None`` -> the CUDA card).
    noise: optional per-chunk tick-noise stream for the cluster (see
        ``Cluster``); ``None`` draws from the cluster's generator.
    """
    if recorder is not None:
        raise NotImplementedError(
            "run_experiment: the trace recorder is not ported yet")
    cluster = Cluster(num_nodes=num_nodes, seed=seed, fleet=fleet,
                      device=device, noise=noise)
    cluster.rollout(30)
    rt_all: list[torch.Tensor] = []
    cpu_series, mem_series = [], []
    placed = rejected = queued_retries = 0
    retry_q: deque[tuple[Pod, int]] = deque()  # (pod, attempts so far)

    def offer(pod: Pod, view) -> bool:
        node = scheduler.select_node(pod, view)
        return node >= 0 and cluster.place(pod, node)

    def drain_retries(view) -> None:
        nonlocal placed, rejected, queued_retries
        for _ in range(len(retry_q)):
            qpod, failed = retry_q.popleft()
            if offer(qpod, view):
                placed += 1
                queued_retries += 1
            elif failed + 1 >= retry_attempts:
                rejected += 1
            else:
                retry_q.append((qpod, failed + 1))

    def advance(ticks: int, record_util: bool = True) -> None:
        # one window per gap; the settle phase records RT but not the util
        # series (Figs. 14-15 average balance over the arrival phase)
        cluster.rollout(ticks)
        rt_all.append(cluster.online_rt_samples())
        if record_util:
            cpu_series.append(cluster.last["cpu_util"])
            mem_series.append(cluster.last["mem_util"])

    for pod, gap in zip(pods, gaps):
        pod = dataclasses.replace(pod)  # fresh copy per scheduler
        view = cluster.view()
        drain_retries(view)
        if offer(pod, view):
            placed += 1
        elif retry_attempts > 0 and len(retry_q) < retry_limit:
            retry_q.append((pod, 0))
        else:
            rejected += 1
        advance(gap)

    drain_retries(cluster.view())
    rejected += len(retry_q)  # still queued at trace end: never placed
    advance(settle_ticks, record_util=False)

    rt = torch.cat(rt_all).cpu().numpy()
    if rt.size == 0:
        rt = np.full(1, np.nan)  # no online pod ever ran
    cpu = torch.stack(cpu_series).cpu().numpy()  # (T, N)
    mem = torch.stack(mem_series).cpu().numpy()
    return ExperimentResult(
        scheduler=scheduler.name,
        avg_rt=float(rt.mean()),
        p90_rt=float(np.percentile(rt, 90)),
        p99_rt=float(np.percentile(rt, 99)),
        cpu_util_std=float((100 * cpu).std(axis=1).mean()),
        mem_util_std=float((100 * mem).std(axis=1).mean()),
        placed=placed,
        rejected=rejected,
        queued_retries=queued_retries,
    )


def compare_schedulers(
    num_pods: int = 60,
    num_nodes: int = 12,
    seed: int = 7,
    predictor=None,
    trace: tuple | None = None,
    fleet=None,
    *,
    device=None,
) -> dict[str, ExperimentResult]:
    """Figs. 13-15 comparison across ICO / RR / HUP / LQP (no control
    loop).  ``trace`` optionally replaces the default arrival trace with a
    (pods, gaps) pair; ``fleet`` swaps in a heterogeneous population."""
    device = resolve_device(device)
    predictor = predictor or train_default_predictor(seed=seed, device=device)
    pods, gaps = trace if trace is not None else _arrival_trace(num_pods, seed)
    return {
        name: run_experiment(sched, pods, gaps, num_nodes=num_nodes,
                             seed=seed, fleet=fleet, device=device)
        for name, sched in make_schedulers(predictor).items()
    }
