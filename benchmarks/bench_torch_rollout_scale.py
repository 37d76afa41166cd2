"""Replay-engine throughput on the PyTorch port: a synthetic placement plan
(a stable online fleet and recurring offline waves, the shape of the
mitigation traces, written directly as an ``extract_plan`` log so that a
1,000-node scenario needs no 1,000-node ``run_experiment``) replayed under
many seeds in one ``state.batched_rollout`` call.

The port's counterpart of ``bench_rollout_scale``, with the same plans,
seeds and row names (prefixed ``torch.``), and its single-card ``vmap``
engine rows only: the 20-seed 3-day 12-node replay (and 7-day with
``--full``), and time-scaled samples of the 1,000-node trace at 2 seeds
(0.1 day; 0.25 day too with ``--full``; marked ``scaled_sample``: the
per-node-tick rate is the comparable number).  Each row reports cold and
warm wall seconds, windows/s and node-ticks/s from the warm wall.  In the
port nothing compiles, so "cold" holds the first launches, library
set-up and allocations.

JAX's ``shard`` rows, its ``--devices`` flag and its CI gate on them
(speedup >= 2x on 4 host devices, parity <= 1e-5) have no counterpart:
``batched_rollout`` refuses to shard seeds across cards (seed sharding is
not ported), and the port forces no devices.

Seed ``s`` draws what ``Cluster(seed=s)`` draws (``state.SeedNoise``), in
place of JAX's per-seed ``chunk_key_stream`` keys; ``build_scenario``
takes an optional per-seed noise factory ``noise(seed, num_nodes)`` instead
(the tests inject JAX's draws with it).  The replay runs the fused
``rollout_tick`` kernel tick (JAX's ``use_pallas``), one launch a batched
tick on the card.  ``--json [PATH]`` dumps the rows.  ``--device`` picks
where the port runs (default: the CUDA card; ``--device cpu`` the CPU).

    PYTHONPATH=src python benchmarks/bench_torch_rollout_scale.py --device cpu
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.cluster import state as cstate
from repro_torch.cluster import workloads as W
from repro_torch.device import resolve_device, sync

SIM_SEEDS = tuple(range(20))
WINDOW_TICKS = 40
TICKS_PER_DAY = 2880
SAMPLE_SEEDS = (0, 1)      # seed axis of the scaled 1,000-node sample rows


def _synthetic_plan(num_nodes: int, days: float, seed: int = 0):
    """A mutation log shaped like the bursty mitigation traces: two online
    services per node at t=0, then offline waves every ~160 ticks that
    expire on their own.  Returns (log, t_end)."""
    rng = np.random.default_rng(seed)
    t_end = int(days * TICKS_PER_DAY)
    log = []
    num_types = len(W.ONLINE_NAMES)
    for node in range(num_nodes):
        for slot in (0, 1):
            log.append(("place_on", 0.0, node, slot,
                        int(rng.integers(0, num_types)),
                        float(rng.uniform(180, 420)),
                        float(rng.uniform(0, 6.28))))
    t, wave = 160, 0
    while t < t_end - 10:
        for j in range(4):  # one wave = 4 co-scheduled jobs
            node = int((wave * 7 + j * 3) % num_nodes)
            log.append(("place_off", float(t), node, j % 6,
                        2.0, 4.0, 8.0, float(rng.uniform(1.2, 2.1)),
                        int(rng.integers(120, 240))))
        wave += 1
        t += int(rng.integers(140, 200))
    return log, t_end


def build_scenario(num_nodes: int, days: float, *, device, noise=None,
                   seeds=None) -> dict:
    """The plan's events in windows of ``WINDOW_TICKS``, the empty state,
    the profiles and a factory of fresh per-seed noise streams (the
    ``SeedNoise`` of each seed, or ``noise(seed, num_nodes)``)."""
    log, t_end = _synthetic_plan(num_nodes, days)
    cpw = max(1, WINDOW_TICKS // cstate.CHUNK)
    num_windows = -(-(t_end // cstate.CHUNK) // cpw)
    events = cstate.extract_plan(log, 0.0, num_windows, cpw)
    if seeds is None:
        seeds = SIM_SEEDS if num_nodes <= 100 else SAMPLE_SEEDS
    if noise is None:
        def streams():
            return [cstate.SeedNoise(s, num_nodes, device) for s in seeds]
    else:
        def streams():
            return [noise(s, num_nodes) for s in seeds]
    return dict(state0=cstate.ClusterState.create(num_nodes, device=device),
                profiles={k: torch.as_tensor(v, device=device)
                          for k, v in W.online_arrays().items()},
                streams=streams, events=events, seeds=tuple(seeds),
                num_windows=num_windows, t_end=t_end, num_nodes=num_nodes,
                device=device)


def _seed_p99(rt: torch.Tensor, t_end: int) -> list:
    """Per-seed p99 over the sampling span (warmup < 30 skipped),
    from the (B, W, span, N, S_ON) RT series; the positive samples of the
    valid ticks go to the host and numpy takes the percentile."""
    span = rt.shape[1] * rt.shape[2]
    tick = np.arange(span).reshape(rt.shape[1], rt.shape[2])
    valid = torch.as_tensor((tick >= 30) & (tick < t_end), device=rt.device)
    out = []
    for i in range(rt.shape[0]):
        s = rt[i][valid]
        s = s[s > 0].cpu().numpy()
        out.append(float(np.percentile(s, 99)) if s.size else float("nan"))
    return out


def time_engine(sc: dict):
    """(row, per-seed p99): the fused replay timed twice, cold then warm,
    each ending in a device drain."""
    device = sc["device"]

    def once():
        streams = sc["streams"]()
        sync(device)
        t0 = time.perf_counter()
        _, outs = cstate.batched_rollout(
            sc["state0"], sc["profiles"], 0.0, streams, sc["events"],
            use_fused=True)
        sync(device)
        return time.perf_counter() - t0, outs

    cold, _ = once()
    warm, outs = once()
    rt = outs["rt"]
    b, w = rt.shape[0], rt.shape[1]
    ticks = w * rt.shape[2]
    return {
        "cold_s": round(cold, 3),
        "warm_s": round(warm, 3),
        "windows_per_s": round(b * w / warm, 2),
        "node_ticks_per_s": round(b * ticks * sc["num_nodes"] / warm, 1),
    }, _seed_p99(rt, sc["t_end"])


def scenario_row(days: float, nodes: int, *, device, out=None,
                 rows=None) -> tuple[dict, list]:
    """One ``vmap`` row of the grid: (row, per-seed p99); ``out`` and
    ``rows`` receive the CSV row and the JSON record."""
    sc = build_scenario(nodes, days, device=device)
    row, p99 = time_engine(sc)
    label = f"{days:g}day_{nodes}n"
    rec = {"scenario": label, "engine": "vmap", "days": days,
           "nodes": nodes, "seeds": len(sc["seeds"]),
           "windows": sc["num_windows"], "scaled_sample": nodes > 100,
           **row}
    if rows is not None:
        rows.append(rec)
    if out is not None:
        out.append((
            f"torch.rollout_scale_{label}_vmap",
            row["warm_s"] * 1e6,
            f"windows_per_s={row['windows_per_s']};"
            f"node_ticks_per_s={row['node_ticks_per_s']};devices=1;"
            f"cold_s={row['cold_s']}",
        ))
    return rec, p99


def run(fast: bool = True, json_path: str | None = None, *,
        device=None) -> list:
    device = resolve_device(device)
    grid = [(3.0, 12)] if fast else [(3.0, 12), (7.0, 12)]
    # 1,000-node rows: time-scaled samples, per-node-tick comparable
    samples = [(0.1, 1000)] if fast else [(0.1, 1000), (0.25, 1000)]
    out, rows = [], []
    for days, nodes in grid + samples:
        scenario_row(days, nodes, device=device, out=out, rows=rows)
    doc = {"devices": 1, "backend": device.type, "fast": fast, "rows": rows}
    if device.type == "cuda":
        doc["card"] = torch.cuda.get_device_name(device)
    if json_path:
        with open(json_path, "w") as f:
            json.dump(doc, f, indent=2)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--full", action="store_true",
                    help="add the 7-day and the 0.25-day 1,000-node rows")
    ap.add_argument("--json", nargs="?",
                    const="BENCH_torch_rollout_scale.json", default=None,
                    help="dump the rows as JSON")
    args = ap.parse_args()
    print("name,us_per_call,derived")
    for name, us, derived in run(fast=not args.full, json_path=args.json,
                                 device=args.device):
        print(f"{name},{us:.1f},{derived}")


if __name__ == "__main__":
    main()
