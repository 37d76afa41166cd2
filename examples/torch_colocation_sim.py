"""Co-located train + serve under ICO on the PyTorch port: the paper's
scenario with the framework's own workloads as the pods (the counterpart
of ``examples/colocation_sim.py``).

Online pods = LM serving jobs (``repro_torch.serve``) whose declared QPS
drives their simulated resource demand; offline pods = training jobs.  The
ICO scheduler places both on the simulated cluster; then a real
``ServeEngine`` on the smollm-135m smoke model shows the runqlat metric
flowing end to end from framework telemetry into Eq. (1)/(3).

Every admission runs with a ``TraceRecorder`` attached, so after the
stream is placed the demo replays one decision from the trace: the full
per-node Eq. (4)-(6) breakdown behind "why did this pod land there".

Run: PYTHONPATH=src python examples/torch_colocation_sim.py [--device cpu]
(default device: the CUDA card; ``--selftest`` runs a seconds-scale smoke
instead: one traced admission on a 2-node cluster, no predictor training,
no model init).
"""
import argparse

import numpy as np
import torch

from repro_torch.cluster.experiment import (
    make_schedulers,
    train_default_predictor,
)
from repro_torch.cluster.simulator import Cluster
from repro_torch.cluster.workloads import OFFLINE_PROFILES, ONLINE_PROFILES, Pod
from repro_torch.configs import get_smoke_config
from repro_torch.core import ICOScheduler, InterferenceQuantifier, metric
from repro_torch.core.interference import node_interference
from repro_torch.device import resolve_device
from repro_torch.models.model import Model
from repro_torch.obs import Trace, TraceRecorder
from repro_torch.obs.explain import explain_pod
from repro_torch.serve import ServeEngine


def _online_pod(qps: float) -> Pod:
    prof = ONLINE_PROFILES["web_search"]
    pod = Pod("web_search", qps, True)
    pod.cpu_demand = prof.cpu_per_qps * qps + prof.cpu_base
    pod.mem_demand = prof.mem_per_qps * qps + prof.mem_base
    return pod


def main(device=None) -> dict:
    """The demo; returns what it printed, for the tests and the chip run:
    the placements, the serve stats and Eq. (1) of the served histogram."""
    device = resolve_device(device)
    print("== training the Eq.(3) predictor on simulated telemetry ==")
    predictor = train_default_predictor(seed=3, num_placements=120,
                                        device=device)
    ico = make_schedulers(predictor)["ICO"]
    rec = TraceRecorder()
    ico.recorder = rec

    cluster = Cluster(num_nodes=6, seed=3, device=device)
    cluster.rollout_scan(30)
    rec.begin_window(cluster.t)

    print("== submitting a mixed train+serve pod stream through ICO ==")
    rng = np.random.default_rng(3)
    placements = []
    for i in range(14):
        if i % 3 != 2:  # two serving pods per training pod
            qps = float(rng.uniform(100, 600))
            pod = _online_pod(qps)
            kind = f"serve(qps={qps:.0f})"
        else:
            prof = OFFLINE_PROFILES["in_memory_analytics"]
            cores = float(rng.choice(prof.cores_choices))
            pod = Pod("in_memory_analytics", 0.0, False, duration=600)
            pod.cpu_demand = cores
            pod.mem_demand = cores * prof.mem_per_core
            kind = f"train(cores={cores:.0f})"
        node = ico.select_node(pod, cluster.view())
        ok = node >= 0 and cluster.place(pod, node)
        rec.resolve_admission(uid=pod.uid if ok else -1, placed=ok)
        placements.append((kind, node if ok else -1))
        cluster.rollout_scan(10)
        rec.begin_window(cluster.t)
        print(f"   pod {i:2d} {kind:18s} -> node {node if ok else 'REJECTED'}")

    trace = Trace(rec.events)
    placed = trace.query("admission", placed=True)
    if placed:
        print("\n== why did the first pod land there?  (from the trace) ==")
        print(explain_pod(trace, placed[0].uid))

    view = cluster.view()
    print("\n== node utilization / interference after placement ==")
    for n in range(cluster.n):
        node_hist = view.online_hists[n].sum(0) + view.offline_hists[n].sum(0)
        avg = float(metric.avg_runqlat(node_hist))
        print(f"   node {n}: cpu={float(view.cpu_util[n]) * 100:5.1f}% "
              f"mem={float(view.mem_util[n]) * 100:5.1f}% "
              f"runqlat_avg={avg:7.1f}u")

    print("\n== real framework telemetry: ServeEngine runqlat -> Eq.(1) ==")
    cfg = get_smoke_config("smollm-135m")
    model = Model(cfg, device=device).init_params(
        torch.Generator(device=device).manual_seed(0))
    eng = ServeEngine(model, max_batch=4)
    for _ in range(8):
        eng.submit(rng.integers(0, cfg.vocab_size, size=(8,)),
                   max_new_tokens=4)
    stats = eng.run()
    print(f"   served {stats['finished']} requests, "
          f"avg latency {stats['avg_latency'] * 1e3:.0f}ms, "
          f"admission runqlat avg {stats['runqlat_avg']:.1f}u")
    # this histogram is exactly what the Data Collection Module exports
    hist = torch.as_tensor(stats["runqlat_hist"], dtype=torch.float32,
                           device=device)
    intf = float(node_interference(hist[None, None, :],
                                   torch.zeros((1, 1, 200), device=device))[0])
    print(f"   -> node interference contribution (Eq.1): {intf:.4f}")
    return {"placements": placements, "admissions": len(placed),
            "serve": stats, "intf": intf}


def selftest(device=None) -> int:
    """Seconds-scale smoke for CI/dev loops: one traced ICO admission on a
    tiny cluster, skipping predictor training and the real ServeEngine.
    Returns the admissions traced (1)."""
    device = resolve_device(device)
    sched = ICOScheduler(InterferenceQuantifier(lambda X: X[:, 21]))
    rec = TraceRecorder()
    sched.recorder = rec
    cluster = Cluster(num_nodes=2, seed=0, device=device)
    cluster.rollout_scan(3)
    rec.begin_window(cluster.t)
    pod = _online_pod(200.0)
    node = sched.select_node(pod, cluster.view())
    if not (node >= 0 and cluster.place(pod, node)):
        raise AssertionError("admission failed")
    rec.resolve_admission(uid=pod.uid, placed=True)
    admitted = Trace(rec.events).query("admission", placed=True)
    if not admitted:
        raise AssertionError("no admission in the trace")
    print(f"torch_colocation_sim selftest: ok ({len(admitted)} admission "
          f"traced, device={device})")
    return len(admitted)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--selftest", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args()
    if args.selftest:
        selftest(args.device)
    else:
        main(args.device)
