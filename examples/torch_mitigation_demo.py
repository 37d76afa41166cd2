"""Runtime interference mitigation, end to end — verified and proactive —
on the PyTorch port (the counterpart of ``examples/mitigation_demo.py``).

Places a small online fleet with ICO, lets the cluster settle, then slams
one node with bursty offline jobs.  The control loop's streaming detector
flags the hotspot from the live runqlat telemetry — and attributes it to
the (node, slot) whose histogram drifted, i.e. the job that landed — the
policy ranks mitigations by calibrated predicted runqlat reduction, the
chosen actions are applied, and one window later each action's prediction
is checked against the runqlat actually observed.  Watch the flagged
node's delay come back down and the per-kind correction factors move away
from 1.0 as the cost model learns how much its estimates over-promise.

Run:  PYTHONPATH=src python examples/torch_mitigation_demo.py [--device cpu]

The cluster, the detector and the forecaster run on ``--device`` (default:
the CUDA card).

``--proactive`` runs the forecast-driven variant instead: the loop's
seasonal forecaster watches each pod's QPS for ~a diurnal period (its
extrapolation-leverage gate stays closed until the observed arc pins the
harmonics down), then projects node runqlat several windows ahead and
lets the detector's forecast-CUSUM raise ``proactive`` flags on predicted
drift — mitigation lands on an incident's leading edge instead of after
it.  Day-scale simulation: expect a few minutes of wall clock.

Both variants run with a ``TraceRecorder`` attached, so the demo ends
with the decision trace's own account of the run: the event census and
the full Planned -> Executed -> Verified lifecycle of the first
mitigation, reconstructed from the trace alone.  Pass
``--trace [PATH]`` to also save the JSONL trace for
``python -m repro_torch.obs.explain``.
"""
import sys

import numpy as np

from repro_torch.cluster.simulator import Cluster
from repro_torch.cluster.workloads import OFFLINE_PROFILES, ONLINE_PROFILES, Pod
from repro_torch.control import ControlLoop, ControlLoopConfig
from repro_torch.core import ICOScheduler, InterferenceQuantifier
from repro_torch.device import resolve_device
from repro_torch.obs import Trace, TraceRecorder
from repro_torch.obs.explain import explain_action, summarize, trust_history


def make_online(name: str, qps: float) -> Pod:
    prof = ONLINE_PROFILES[name]
    pod = Pod(name, qps, True)
    pod.cpu_demand = prof.cpu_per_qps * qps + prof.cpu_base
    pod.mem_demand = prof.mem_per_qps * qps + prof.mem_base
    return pod


def _save_trace(rec: TraceRecorder) -> None:
    if "--trace" in sys.argv:
        i = sys.argv.index("--trace")
        path = (sys.argv[i + 1]
                if i + 1 < len(sys.argv)
                and not sys.argv[i + 1].startswith("--")
                else "torch_mitigation_demo_trace.jsonl")
        n = rec.save(path)
        print(f"\nsaved {n} events to {path} "
              f"(try: python -m repro_torch.obs.explain {path})")


def _device():
    if "--device" in sys.argv:
        return resolve_device(sys.argv[sys.argv.index("--device") + 1])
    return resolve_device(None)


def _delays(cluster):
    return np.round(cluster.last["delay"].cpu().numpy(), 1)


def main() -> None:
    device = _device()
    # a lightweight predictor: the node's current avg runqlat is the
    # predicted pod runqlat (the RF from bench_control is the slow version)
    quantifier = InterferenceQuantifier(lambda X: X[:, 21])
    scheduler = ICOScheduler(quantifier)
    rec = TraceRecorder()
    scheduler.recorder = rec
    loop = ControlLoop(InterferenceQuantifier(lambda X: X[:, 21]),
                       recorder=rec)
    cluster = Cluster(num_nodes=6, seed=42, device=device)
    cluster.rollout(20)
    rec.begin_window(cluster.t)

    print("== placing online fleet via ICO ==")
    for name, qps in [("web_search", 420), ("web_serving", 800),
                      ("media_streaming", 300), ("data_caching", 1500),
                      ("web_search", 300), ("web_serving", 500)]:
        pod = make_online(name, qps)
        node = scheduler.select_node(pod, cluster.view())
        if node < 0 or not cluster.place(pod, node):
            raise RuntimeError(f"ICO could not place {name}")
        rec.resolve_admission(uid=pod.uid, placed=True)
        print(f"  {name:16s} qps={qps:5.0f} -> node {node}")
        cluster.rollout(10)

    cluster.rollout(30)
    print("node delays:", _delays(cluster))

    print("\n== offline burst lands on node 0 ==")
    prof = OFFLINE_PROFILES["graph_analytics"]
    for _ in range(3):
        job = Pod("graph_analytics", 0.0, False, duration=400)
        job.cpu_demand = 12.0
        job.mem_demand = 12.0 * prof.mem_per_core
        if not cluster.place(job, 0):
            raise RuntimeError("node 0 has no free offline slot")
    cluster.rollout(10)
    print("node delays:", _delays(cluster))

    print("\n== control loop: detect -> attribute -> rank -> act -> verify ==")
    for step in range(8):
        cluster.rollout(10)
        rec.begin_window(cluster.t)
        applied = loop.step(cluster)
        delays = _delays(cluster)
        hot = loop.detector.last_diag["cusum"]
        print(f"step {step}: delays={delays} cusum0={hot[0]:.1f}")
        if loop.detector.hot_slots():
            print(f"   attribution (node -> drifted slot): {loop.detector.hot_slots()}")
        for a in applied:
            print(f"   -> {a.describe()}")
        this_step = (loop.history and
                     loop.history[-1]["step"] == loop.stats.steps)
        for v in (loop.history[-1]["verified"] if this_step else []):
            print(f"   verified {v['kind']}@node{v['node']}: "
                  f"predicted {v['predicted']:.1f}, realized {v['realized']:.1f} "
                  f"-> correction {v['correction']:.2f}")

    s = loop.stats
    print(f"\nflagged {s.hotspots_flagged} hotspot-windows, applied "
          f"{s.actions_applied} mitigations: {s.by_kind}")
    print(f"verified {s.actions_verified} of them: predicted "
          f"{s.predicted_reduction:.1f} vs realized {s.realized_reduction:.1f} "
          f"latency-units reduction (rel. error {s.calibration_error():.2f})")
    print("learned corrections:", {k: round(v, 2) for k, v in loop.corrections.items()})
    print("final node delays:", _delays(cluster))

    trace = Trace(rec.events)
    print("\n== what the decision trace says ==")
    print(summarize(trace))
    executed = trace.query("action_executed")
    if executed:
        print("\nfirst mitigation, reconstructed from the trace alone:")
        print(explain_action(trace, executed[0].action_id))
    _save_trace(rec)


def proactive_main() -> None:
    device = _device()
    quantifier = InterferenceQuantifier(lambda X: X[:, 21])
    scheduler = ICOScheduler(quantifier)
    rec = TraceRecorder()
    scheduler.recorder = rec
    loop = ControlLoop(InterferenceQuantifier(lambda X: X[:, 21]),
                       ControlLoopConfig(proactive=True), recorder=rec)
    cluster = Cluster(num_nodes=6, seed=42, device=device)
    cluster.rollout(20)
    rec.begin_window(cluster.t)

    print("== placing online fleet via ICO ==")
    for name, qps in [("web_search", 420), ("web_serving", 800),
                      ("media_streaming", 300), ("data_caching", 1500),
                      ("web_search", 300), ("web_serving", 500)]:
        pod = make_online(name, qps)
        node = scheduler.select_node(pod, cluster.view())
        if node < 0 or not cluster.place(pod, node):
            raise RuntimeError(f"ICO could not place {name}")
        rec.resolve_admission(uid=pod.uid, placed=True)
        cluster.rollout(10)

    prof = OFFLINE_PROFILES["graph_analytics"]
    window, num_windows = 40, 95  # ~1.3 diurnal periods of telemetry
    print(f"== {num_windows} windows x {window} ticks; offline bursts land "
          f"on node 0 every ~15 windows ==")
    armed = False
    for step in range(num_windows):
        if step % 15 == 5:
            job = Pod("graph_analytics", 0.0, False, duration=150)
            job.cpu_demand = 10.0
            job.mem_demand = 10.0 * prof.mem_per_core
            cluster.place(job, 0)
        cluster.rollout(window)
        rec.begin_window(cluster.t)
        applied = loop.step(cluster)
        if not armed and loop.forecaster is not None:
            conf = loop.forecaster.confidence(cluster.t + 6 * window)
            if conf.any():
                armed = True
                print(f"step {step}: forecast channel armed — "
                      f"{int(conf.sum())} pods pass the leverage gate, "
                      f"calibration {loop.forecaster.calibration_error():.3f}")
        h = (loop.history[-1] if loop.history
             and loop.history[-1]["step"] == loop.stats.steps else None)
        if h and (h["proactive_nodes"] or applied):
            print(f"step {step}: hot={h['hot_nodes']} "
                  f"proactive={h['proactive_nodes']}")
            for a in applied:
                print(f"   -> {a.describe()}")

    s = loop.stats
    print(f"\nflagged {s.hotspots_flagged} reactive + {s.proactive_flagged} "
          f"proactive hotspot-windows; applied {s.actions_applied} actions "
          f"({s.proactive_applied} ahead-of-time): {s.by_kind}")
    if loop.forecaster is not None:
        print(f"forecaster one-step calibration error: "
              f"{loop.forecaster.calibration_error():.3f}")
    print("final node delays:", _delays(cluster))

    trace = Trace(rec.events)
    print("\n== what the decision trace says ==")
    print(summarize(trace))
    if trace.query("trust_gate"):
        print("\ntrust-gate history:")
        print(trust_history(trace))
    executed = trace.query("action_executed", proactive=True) \
        or trace.query("action_executed")
    if executed:
        print("\nfirst mitigation, reconstructed from the trace alone:")
        print(explain_action(trace, executed[0].action_id))
    _save_trace(rec)


if __name__ == "__main__":
    if "--proactive" in sys.argv:
        proactive_main()
    else:
        main()
