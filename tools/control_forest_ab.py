#!/usr/bin/env python3
"""Does the forest decide whether control helps ICO on the 12-node trace?

Run from the root of a checkout, on a machine with a CUDA card::

    python3 tools/control_forest_ab.py [--seeds 20] [--devices cuda,cpu]
                                       [--out FILE]

Two forests, ``train_default_predictor(seed=7)`` grown from data drawn on
the card and from data drawn on the CPU, each drive ICO without and with
``ControlLoop(q, scheduler_loop_config("ICO"))`` on
``bursty_trace(num_online=14, seed=0)`` (12 nodes, sim seed 7, the
``control_12`` phase of ``chip_smoke.py``).  Each pair of runs is made on
each device of ``--devices``, and each run's plan is replayed there under
seeds ``0 .. N-1`` with the fused tick: on one device both forests meet
the same noise draws, so a difference between them is the forest's; a
difference between devices with one forest is the noise stream's.

Prints the card's name and power limit, then one JSON line per (forest,
device): the run's p99 without and with control, its mitigations, the
replays' mean and std p99 and the seeds on which control wins.  With
``--out FILE`` the lines are also written to FILE as one JSON list.
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


def forest_on(rf, device):
    """A fitted forest with its tensors on ``device``."""
    out = copy.copy(rf)
    out.device = device
    out.forest = {k: v.to(device) for k, v in rf.forest.items()}
    return out


def ico_pair(rf, device, seeds):
    """ICO without and with its loop on ``device``: each run's p99 and
    mitigations, and its plan's replays under ``seeds``."""
    import numpy as np

    from repro_torch.cluster.experiment import (
        bursty_trace,
        replay_plan_batched,
        run_experiment,
    )
    from repro_torch.control import ControlLoop, scheduler_loop_config
    from repro_torch.core import ICOScheduler, InterferenceQuantifier

    pods, gaps = bursty_trace(num_online=14, seed=0)
    out, p99 = {}, {}
    for on in (False, True):
        q = InterferenceQuantifier(rf.predict)
        plan = {}
        r = run_experiment(
            ICOScheduler(q), pods, gaps, num_nodes=12, seed=7,
            control_loop=ControlLoop(q, scheduler_loop_config("ICO"))
            if on else None, plan_out=plan, device=device)
        rep = replay_plan_batched(plan, sim_seeds=tuple(seeds),
                                  window_ticks=40, use_fused=True,
                                  device=device)
        by_seed = {e["sim_seed"]: e["p99_rt"] for e in rep["seeds"]}
        p99[on] = np.array([by_seed[s] for s in seeds])
        tag = "on" if on else "off"
        out[f"p99_{tag}"] = r.p99_rt
        out[f"replay_p99_mean_{tag}"] = float(p99[on].mean())
        out[f"replay_p99_std_{tag}"] = float(p99[on].std())
        if on:
            out["mitigations"] = r.mitigations
    out["wins"] = int((p99[True] < p99[False]).sum())
    out["seeds"] = len(seeds)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=20)
    ap.add_argument("--devices", default="cuda,cpu")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch

    from repro_torch.cluster.experiment import train_default_predictor

    if not torch.cuda.is_available():
        print("control_forest_ab: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    forests = {dev: train_default_predictor(seed=7, device=dev)
               for dev in ("cuda", "cpu")}
    lines = []
    for dev in args.devices.split(","):
        for grown, rf in forests.items():
            row = {"forest_grown_on": grown, "run_on": dev,
                   **ico_pair(forest_on(rf, torch.device(dev)),
                              torch.device(dev), range(args.seeds))}
            print(json.dumps(row), flush=True)
            lines.append(row)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(lines, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
