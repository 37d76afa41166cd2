"""Motivation experiments -- paper Section II (Figs. 1-4, Table I).

Port of ``repro.cluster.motivation``.  Exp1 fixes Web Search QPS (300) and
sweeps the offline job's CPU cores 2..20; Exp2 fixes offline cores (8) and
sweeps Web Search QPS 200..2000.  Each configuration is one single-node
rollout on the port's ``Cluster`` (one ``runqlat_hist`` launch a tick on
the card), recording (cpu_util, avg_runqlat, avg_response_time); response
time is then fitted against each predictor and the fits compared by MAPE
and R2.

``noise`` is an optional factory ``noise(seed, num_nodes)`` returning the
per-chunk tick-noise stream of the run with that seed (``Cluster(noise=)``);
the tests pass one that replays JAX's draws.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.cluster.simulator import Cluster
from repro_torch.cluster.workloads import OFFLINE_PROFILES, ONLINE_PROFILES, Pod
from repro_torch.core import metric


def _measure(qps: float, offline_cores: float, window: int = 120,
             seed: int = 0, *, device=None, noise=None):
    cluster = Cluster(num_nodes=1, seed=seed, device=device,
                      noise=None if noise is None else noise(seed, 1))
    web = Pod("web_search", qps, True)
    prof = ONLINE_PROFILES["web_search"]
    web.cpu_demand = prof.cpu_per_qps * qps + prof.cpu_base
    web.mem_demand = prof.mem_per_qps * qps + prof.mem_base
    if not cluster.place(web, 0):
        raise RuntimeError("web_search did not fit on the empty node")
    job = Pod("in_memory_analytics", 0.0, False, duration=10**6)
    job.cpu_demand = offline_cores
    job.mem_demand = (offline_cores
                      * OFFLINE_PROFILES["in_memory_analytics"].mem_per_core)
    if not cluster.place(job, 0):
        raise RuntimeError("the offline job did not fit beside web_search")
    s = cluster.rollout(window)
    rt = cluster.online_rt_samples().mean()
    runqlat = metric.avg_runqlat(s["hist_on"][0, 0])
    cpu, runqlat, rt = torch.stack([s["cpu_util"][0], runqlat, rt]).tolist()
    return cpu, runqlat, rt


def experiment1(seed: int = 0, *, device=None, noise=None) -> np.ndarray:
    """Vary offline cores, QPS fixed at 300 (10 settings, as in the paper).
    Returns (10, 3): cpu, runqlat, rt."""
    rows = [_measure(300.0, c, seed=seed + i, device=device, noise=noise)
            for i, c in enumerate(range(2, 22, 2))]
    return np.asarray(rows)


def experiment2(seed: int = 100, *, device=None, noise=None) -> np.ndarray:
    """Vary QPS 200..2000, offline cores fixed at 8."""
    rows = [_measure(float(q), 8.0, seed=seed + i, device=device,
                     noise=noise)
            for i, q in enumerate(range(200, 2200, 200))]
    return np.asarray(rows)


def fit_quality(x: np.ndarray, y: np.ndarray, degree: int = 2):
    """Polynomial fit (as the paper 'attempted to fit a curve'); returns
    (MAPE, R2)."""
    coef = np.polyfit(x, y, degree)
    pred = np.polyval(coef, x)
    mape = float(np.mean(np.abs(pred - y) / np.maximum(np.abs(y), 1e-9)))
    ss_res = float(((y - pred) ** 2).sum())
    ss_tot = float(((y - y.mean()) ** 2).sum())
    return mape, 1.0 - ss_res / max(ss_tot, 1e-12)


def table1(seed: int = 0, *, device=None,
           noise=None) -> dict[str, tuple[float, float]]:
    """Reproduce Table I: curve-fit quality for runqlat-resp vs cpu-resp."""
    e1 = experiment1(seed, device=device, noise=noise)
    e2 = experiment2(seed + 100, device=device, noise=noise)
    return {
        "exp1_runqlat_resp": fit_quality(e1[:, 1], e1[:, 2]),
        "exp1_cpu_resp": fit_quality(e1[:, 0], e1[:, 2]),
        "exp2_runqlat_resp": fit_quality(e2[:, 1], e2[:, 2]),
        "exp2_cpu_resp": fit_quality(e2[:, 0], e2[:, 2]),
    }
