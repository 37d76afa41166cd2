#!/usr/bin/env python3
"""The fused rollout tick of this tree against an earlier tree's, on one card.

Run from the root of a checkout, on a machine with a CUDA card::

    python3 tools/rollout_tick_ab.py --parent DIR [--out FILE]

``DIR`` is an unpacked checkout of the earlier commit (``git archive``)
whose ``rollout_tick`` took the packed JAX layout
(``rollout_tick_launch(nodev, jit, act, u1, u2, hist, delay, mean, rows,
slots, k, gamma_shape, clip_max, device, stream)``).  Steps:

1. the 1,000-node ICO run of ``chip_smoke.py`` (phase 4), recording its
   plan;
2. the replay's 5,000th batched tick (20 seeds x 1,000 nodes), captured as
   ``chip_smoke.py`` phase 9 captures it;
3. on that tick, each from a CUDA graph of 20 calls (``graph_ms``, so no
   host time) in the order earlier, this, this, earlier: the earlier
   tree's kernel (its ``csrc/rollout_tick.cu`` built here with this tree's
   ``nvcc`` flags) on ``pack(*tick)``, this tree's kernel on the tick's
   tensors; then ``pack`` alone, ``pack`` plus the earlier kernel, and this
   tree's kernel on the packed layout.  The two kernels' outputs must be
   equal bit for bit.  The wrapper call of this tree is also timed by CUDA
   events, so with its host time;
4. in a child process per tree, in the order earlier, this, this, earlier:
   ``chip_smoke.phase_replay_profile`` (host ms, device time and launches
   per batched tick, fused and default tick), then the 20-seed replay of
   the plan with the fused tick (wall, batched ticks/s, ``rollout_tick``
   launches, the seed-7 entry, which must be the same in every child).

Prints the card's name and power limit and one JSON line per step, and
with ``--out FILE`` also writes all of it to FILE as one JSON list.
Exits non-zero on any failed check.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import pickle
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEEDS, WINDOW_TICKS, TICK = tuple(range(20)), 40, 5000


def _out(rec: dict) -> None:
    print(json.dumps(rec), flush=True)


def _parent_kernel(torch, build, RT, parent: str, scratch: str):
    """The earlier tree's ``rollout_tick`` kernel, built from its source,
    as a function of the packed inputs."""
    src = os.path.join(parent, "src", "repro_torch", "kernels", "csrc",
                       "rollout_tick.cu")
    lib = os.path.join(scratch, "rollout_tick_parent.so")
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", lib, src],
                   check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(lib).rollout_tick_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(nodev, jit_all, act_all, u1, u2):
        rows, slots = jit_all.shape
        outs = RT._outputs(rows, slots, nodev.device)
        index, stream = build.device_and_stream(nodev)
        err = fn(nodev.data_ptr(), jit_all.data_ptr(), act_all.data_ptr(),
                 u1.data_ptr(), u2.data_ptr(),
                 *(o.data_ptr() for o in outs), rows, slots,
                 u1.shape[1] // slots, 2.0, RT.CLIP_MAX, index, stream)
        if err:
            raise RuntimeError(f"earlier rollout_tick failed: {err}")
        return outs
    return run


def kernel_ab(torch, cs, RT, build, cstate, texp, plan, parent, scratch):
    card = torch.device("cuda")
    args = cs.capture_replay_tick(torch, cstate, texp, RT, plan, SEEDS, TICK,
                                  card)
    packed = RT.pack(*args)
    old = _parent_kernel(torch, build, RT, parent, scratch)
    got, want = RT.fused_tick_unpacked(*args), old(*packed)
    torch.cuda.synchronize()
    for name, a, b in zip(("hist", "delay", "mean"), got, want):
        if not torch.equal(a, b):
            raise AssertionError(f"rollout_tick {name}: this tree != earlier")
    runs = {}
    for name, fn in (("earlier_kernel", lambda: old(*packed)),
                     ("kernel", lambda: RT.fused_tick_unpacked(*args)),
                     ("kernel2", lambda: RT.fused_tick_unpacked(*args)),
                     ("earlier_kernel2", lambda: old(*packed)),
                     ("pack", lambda: RT.pack(*args)),
                     ("pack_and_earlier_kernel",
                      lambda: old(*RT.pack(*args))),
                     ("kernel_packed", lambda: RT.fused_tick(*packed))):
        runs[name] = cs.graph_ms(torch, fn) * 1e3
    call_us = cs.cuda_ms(lambda: RT.fused_tick_unpacked(*args)) * 1e3
    return dict(step="kernel", rows=args[0][0].shape[0],
                active_slots=int(args[3].count_nonzero()
                                 + args[4].count_nonzero()),
                device_us=runs, kernel_call_us_by_events=call_us)


def child(tree: str, plan_path: str) -> None:
    """One tree's replay numbers (step 4), as one JSON line."""
    sys.path.insert(0, os.path.join(tree, "src"))
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs
    from repro_torch.cluster import experiment as texp
    from repro_torch.cluster import state as cstate
    from repro_torch.kernels import build
    from repro_torch.kernels import rollout_tick as RT

    card = torch.device("cuda")
    build.build(["runqlat_hist", "rollout_tick"])
    with open(plan_path, "rb") as f:
        plan = pickle.load(f)
    prof = cs.phase_replay_profile(torch, cstate, texp, RT, plan, card)
    RT.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rep = texp.replay_plan_batched(plan, sim_seeds=SEEDS,
                                   window_ticks=WINDOW_TICKS, use_fused=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    bticks = rep["padded_windows"] * WINDOW_TICKS
    seed7 = next(e for e in rep["seeds"] if e["sim_seed"] == 7)
    _out(dict(step="replay", tree=tree, wall_s=wall,
              replay_wall_s=rep["wall_s"], batched_ticks=bticks,
              real_batched_ticks_per_s=int(plan["t_end"]) / wall,
              rollout_tick_launches=RT.launches,
              launches_per_batched_tick=RT.launches / bticks,
              seed7={k: seed7[k] for k in ("avg_rt", "p90_rt", "p99_rt")},
              fused={k: v for k, v in prof["fused"].items() if k != "top"},
              default={k: v for k, v in prof["default"].items()
                       if k != "top"}))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True,
                    help="unpacked checkout of the earlier commit")
    ap.add_argument("--out", help="also write the records here")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--plan", help=argparse.SUPPRESS)
    opts = ap.parse_args()
    if opts.child:
        child(opts.child, opts.plan)
        return 0

    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("rollout_tick_ab: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.cluster import experiment as texp
    from repro_torch.cluster import state as cstate
    from repro_torch.cluster.fleet import make_fleet
    from repro_torch.core import ICOScheduler, InterferenceQuantifier
    from repro_torch.kernels import build
    from repro_torch.kernels import rollout_tick as RT

    card_line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card_line.strip(), flush=True)
    records = [dict(step="card", nvidia_smi=card_line.strip())]
    build.build(["runqlat_hist", "rollout_tick"])
    rf = texp.train_default_predictor(seed=7)
    pods, gaps = texp._arrival_trace(600, seed=7)
    plan: dict = {}
    res = texp.run_experiment(ICOScheduler(InterferenceQuantifier(rf.predict)),
                              pods, gaps, fleet=make_fleet(1000, cs.MIX,
                                                           seed=0),
                              seed=7, plan_out=plan)
    records.append(dict(step="ico_1000", avg_rt=res.avg_rt,
                        p90_rt=res.p90_rt, p99_rt=res.p99_rt))
    _out(records[-1])
    with tempfile.TemporaryDirectory() as scratch:
        records.append(kernel_ab(torch, cs, RT, build, cstate, texp, plan,
                                 opts.parent, scratch))
        _out(records[-1])
        plan_path = os.path.join(scratch, "plan.pkl")
        with open(plan_path, "wb") as f:
            pickle.dump(plan, f)
        del plan, rf
        torch.cuda.empty_cache()
        for tree in (opts.parent, ROOT, ROOT, opts.parent):
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--parent",
                 opts.parent, "--child", tree, "--plan", plan_path],
                capture_output=True, text=True)
            if proc.returncode:
                print(proc.stdout, proc.stderr, file=sys.stderr)
                raise RuntimeError(f"replay in {tree} exited "
                                   f"{proc.returncode}")
            records.append(json.loads(proc.stdout.strip().splitlines()[-1]))
            records[-1]["tree"] = ("earlier" if tree == opts.parent
                                   else "this")
            _out(records[-1])
    seed7 = {json.dumps(r["seed7"]) for r in records
             if r["step"] == "replay"}
    if len(seed7) != 1:
        raise AssertionError(f"seed-7 entries differ across trees: {seed7}")
    for r in records:
        if r["step"] == "replay" and (r["rollout_tick_launches"]
                                      != r["batched_ticks"]):
            raise AssertionError(f"{r['rollout_tick_launches']} launches for "
                                 f"{r['batched_ticks']} batched ticks")
    if opts.out:
        os.makedirs(os.path.dirname(os.path.abspath(opts.out)), exist_ok=True)
        with open(opts.out, "w") as f:
            json.dump(records, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
