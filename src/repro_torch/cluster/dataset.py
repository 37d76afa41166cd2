"""Training data for the Scheduling Latency Prediction Module.

Port of ``repro.cluster.dataset``: randomized placements on the simulator,
recording per online placement the Table-III feature row (pod QPS + node
telemetry at decision time) and the label, the pod's realized average
runqlat over the next window.
"""
from __future__ import annotations

import numpy as np

from repro_torch.cluster import workloads as W
from repro_torch.cluster.simulator import Cluster
from repro_torch.cluster.workloads import Pod
from repro_torch.core import metric


def _random_pod(rng) -> Pod:
    if rng.random() < 0.55:
        name = rng.choice(W.ONLINE_NAMES)
        prof = W.ONLINE_PROFILES[name]
        qps = float(rng.uniform(50, 900))
        pod = Pod(name, qps, True)
        pod.cpu_demand = prof.cpu_per_qps * qps + prof.cpu_base
        pod.mem_demand = prof.mem_per_qps * qps + prof.mem_base
    else:
        name = rng.choice(W.OFFLINE_NAMES)
        prof = W.OFFLINE_PROFILES[name]
        cores = float(rng.choice(prof.cores_choices))
        pod = Pod(name, 0.0, False,
                  duration=int(rng.integers(*prof.duration_range)))
        pod.cpu_demand = cores
        pod.mem_demand = cores * prof.mem_per_core
    return pod


def generate_latency_dataset(num_placements: int = 400, num_nodes: int = 10,
                             window: int = 30, seed: int = 0, *,
                             device=None):
    """Returns (X, y) numpy float64: X (M, 46) Table-III rows, y (M,)
    realized avg runqlat.  Only online placements produce rows; offline
    pods are co-placed to create the interference the model learns."""
    rng = np.random.default_rng(seed)
    cluster = Cluster(num_nodes=num_nodes, seed=seed, device=device)
    cluster.rollout(window)  # warm telemetry

    X, y = [], []
    watched: list[tuple[int, np.ndarray, int]] = []

    for _ in range(num_placements):
        view = cluster.view()
        pod = _random_pod(rng)
        # random placement -> diverse (features, outcome) coverage
        candidates = np.arange(cluster.n)
        rng.shuffle(candidates)
        placed_node = -1
        for c in candidates:
            if cluster.place(pod, int(c)):
                placed_node = int(c)
                break
        if placed_node < 0:
            # cluster full: free a random pod
            uids = list(cluster._pod_slots)
            cluster.remove(uids[rng.integers(len(uids))])
            continue

        if pod.is_online:
            feats = view.features[placed_node].cpu().numpy()
            watched.append((pod.uid, np.concatenate([[pod.qps], feats]),
                            placed_node))

        cluster.rollout(window)

        for uid, row, _node in watched:
            kind, n_, s_ = cluster._pod_slots.get(uid, (None, None, None))
            if kind is None:
                continue
            hist = cluster.last["hist_on"][n_, s_]
            X.append(row)
            y.append(float(metric.avg_runqlat(hist)))
        watched = []

        # occasionally retire pods to keep churn realistic
        if rng.random() < 0.35 and cluster._pod_slots:
            uids = list(cluster._pod_slots)
            cluster.remove(uids[rng.integers(len(uids))])

    return np.asarray(X, np.float64), np.asarray(y, np.float64)
