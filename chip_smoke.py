#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

Run from the root of a checkout: ``python3 chip_smoke.py`` (no arguments;
one card).  It imports ``repro_torch`` from ``src/`` and nothing of JAX.
Phases, each printed with its numbers and wall time:

1. build every CUDA kernel of the path from ``src/repro_torch/kernels/csrc``;
2. hold ``runqlat_hist`` against its plain version on the card (main-path
   shapes exactly, a ragged shape with float weights to tolerance) and time
   it beside the plain version and ``scatter_add_`` on a precomputed index;
3. run ten ticks at 1,000 nodes on the card and on the CPU with one noise
   bundle: the same state, floats allclose, histogram totals equal;
4. the main path at full width: train the Random Forest on the card;
   profile 100 ticks and 20 admissions on the 1,000-node cluster of phase
   3 (host ms per tick, the device's busy share, its top kernels); then
   ICO ``run_experiment`` on a 1,000-node fleet with a 600-pod trace, with
   the kernel's launch count set to 0 before and read after the run;
5. the paper-scale ``compare_schedulers`` table (12 nodes, 40 pods);
6. one 12-node ICO run on the card and on the CPU with one noise stream:
   the same placements, response times allclose.

Then it prints the card's name and power limit, one JSON line of kernel
numbers, and last ``{"ok": true, "device": {...}}``.  Any failure raises
and exits non-zero; without a card it exits 1 before doing anything.
"""
import copy
import dataclasses
import json
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
FP32_OPS_PER_S = 67e12           # float32 outside the tensor cores
MIX = {"std32": 6, "hi96": 1, "lo16": 3}


def say(phase, **kv):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def cuda_ms(fn, iters=200, warmup=20):
    """Mean milliseconds per call of ``fn`` on the card (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def phase_kernel(torch, K, card):
    """Kernel vs plain version on the card, and its times at the shapes one
    1,000-node tick gives it (8,000 online and 6,000 offline series of 16)."""
    g = torch.Generator(device=card).manual_seed(0)
    shapes = [(8000, 16), (6000, 16)]
    cases, max_err = [], 0.0
    for S, N in shapes:
        s = torch.rand((S, N), generator=g, device=card) * 1210.0 - 10.0
        w = (torch.rand((S, 1), generator=g, device=card) < 0.6).float()
        w = w.expand(S, N).contiguous()
        got, want = K.runqlat_hist(s, w), K.runqlat_hist_plain(s, w)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"runqlat_hist != plain at {(S, N)}")
        if not torch.equal(got.sum(-1), w.sum(-1)):
            raise AssertionError("zero weights leaked into the histogram")
        cases.append((s, w))
    # ragged, general float weights (with zeros): atomics add in no fixed
    # order, so this agrees to float32 rounding
    s = torch.rand((64, 5003), generator=g, device=card) * 1210.0 - 10.0
    w = torch.rand((64, 5003), generator=g, device=card)
    w = w * (torch.rand((64, 5003), generator=g, device=card) < 0.8)
    got, want = K.runqlat_hist(s, w), K.runqlat_hist_plain(s, w)
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=1e-5, atol=1e-4):
        raise AssertionError(f"ragged float-weight case: max err {err}")
    max_err = max(max_err, err)
    say("kernel-check", main_path_equal=True, ragged_shape="64x5003",
        ragged_max_abs_err=err)

    idx = [torch.clamp(torch.floor(s / 5.0), 0, 199).long() for s, _ in cases]

    def kernel():
        for s, w in cases:
            K.runqlat_hist(s, w)

    def plain():
        for s, w in cases:
            K.runqlat_hist_plain(s, w)

    def library():
        for (s, w), i in zip(cases, idx):
            torch.zeros((s.shape[0], 200), device=card).scatter_add_(1, i, w)

    ms = {}
    for name, fn in (("plain", plain), ("kernel", kernel),
                     ("kernel2", kernel), ("plain2", plain),
                     ("library", library)):
        ms[name] = cuda_ms(fn)
    nbytes = sum(4 * (s.numel() * 2 + s.shape[0] * 200) for s, _ in cases)
    nops = sum(6 * s.numel() for s, _ in cases)  # div, floor, 2 clamps, cast, add
    bound_ms = max(nbytes / HBM_BYTES_PER_S, nops / FP32_OPS_PER_S) * 1e3
    kernel_ms = min(ms["kernel"], ms["kernel2"])
    plain_ms = min(ms["plain"], ms["plain2"])
    say("kernel-time", per_tick_shapes="8000x16+6000x16", bytes=nbytes,
        kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=ms["library"],
        bound_ms=bound_ms, runs=json.dumps(ms))
    return dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=ms["library"],
                bound_ms=bound_ms, max_abs_err=max_err)


def loaded_cluster(Cluster, make_fleet, Pod, W, num_nodes, device, seed=0):
    """A fleet cluster with online and offline pods on most nodes."""
    import numpy as np

    c = Cluster(fleet=make_fleet(num_nodes, MIX, seed=0), seed=seed,
                device=device)
    rng = np.random.default_rng(seed)
    for i in range(4 * num_nodes):
        if rng.random() < 0.6:
            name = str(rng.choice(W.ONLINE_NAMES))
            pod = Pod(name, float(rng.uniform(50, 900)), True)
        else:
            name = str(rng.choice(W.OFFLINE_NAMES))
            pod = Pod(name, 0.0, False, duration=int(rng.integers(3, 40)))
            pod.cpu_demand = float(rng.choice([2, 4, 8]))
        c.place(pod, int(rng.integers(num_nodes)))
    return c


def phase_profile(torch, c, sched, pods, ticks=100):
    """Where time goes at 1,000 nodes: host ms per tick, then one rollout
    under ``torch.profiler`` for the device's busy share and its kernels,
    then host ms per admission (one view and one ICO decision)."""
    from torch.profiler import ProfilerActivity, profile

    c.rollout(20)                                   # warm the path
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    c.rollout(ticks)
    torch.cuda.synchronize()
    tick_ms = (time.perf_counter() - t0) * 1e3 / ticks
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        c.rollout(ticks)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in rows)
    top = sorted(rows, key=lambda e: -e.self_device_time_total)[:6]
    say("profile", ticks=ticks, host_ms_per_tick=tick_ms,
        profiled_ms_per_tick=wall_s * 1e3 / ticks,
        device_busy_share=device_us * 1e-6 / wall_s,
        device_us_per_tick=device_us / ticks,
        kernels_per_tick=sum(e.count for e in rows) / ticks,
        top=json.dumps([[e.key[:48], e.self_device_time_total / ticks,
                         e.count / ticks] for e in top]))
    t0 = time.perf_counter()
    for pod in pods:
        sched.select_node(pod, c.view())
    say("profile", admissions=len(pods),
        host_ms_per_admission=(time.perf_counter() - t0) * 1e3 / len(pods))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "src"))
    import numpy as np

    from repro_torch.cluster import state as cstate
    from repro_torch.cluster import workloads as W
    from repro_torch.cluster.experiment import (
        _arrival_trace,
        compare_schedulers,
        run_experiment,
        train_default_predictor,
    )
    from repro_torch.cluster.fleet import make_fleet
    from repro_torch.cluster.simulator import Cluster
    from repro_torch.cluster.workloads import Pod
    from repro_torch.core import ICOScheduler, InterferenceQuantifier
    from repro_torch.kernels import build
    from repro_torch.kernels import runqlat_hist as K
    from repro_torch.obs import PhaseTimers

    card, cpu = torch.device("cuda"), torch.device("cpu")
    timers = PhaseTimers()

    def done(name, **kv):
        say(name, wall_s=timers.totals[name], **kv)

    # 1. build ------------------------------------------------------------
    with timers.phase("build"):
        build.build(["runqlat_hist"])
    done("build", ptxas=json.dumps(build.build_logs.get("runqlat_hist", "")
                                   .strip().splitlines()[-2:]))

    # 2. kernel against its plain version ---------------------------------
    with timers.phase("kernel"):
        knums = phase_kernel(torch, K, card)
    done("kernel")

    # 3. ten ticks at 1,000 nodes, card vs CPU, one noise bundle ----------
    with timers.phase("ticks"):
        c = loaded_cluster(Cluster, make_fleet, Pod, W, 1000, card)
        noise = cstate.draw_noise(torch.Generator(device=card).manual_seed(3),
                                  c.n, cstate.CHUNK)

        def to(dev, obj):
            return type(obj)(**{k: v.to(dev) for k, v in vars(obj).items()})

        gst, gout = cstate._window_core(c.state, c.profiles, c.fleet_params,
                                        0.0, noise)
        cst, cout = cstate._window_core(
            to(cpu, c.state), {k: v.cpu() for k, v in c.profiles.items()},
            to(cpu, c.fleet_params), 0.0, [to(cpu, n) for n in noise])
        for k, v in vars(gst).items():
            if not torch.equal(v.cpu(), getattr(cst, k)):
                raise AssertionError(f"tick state {k}: card != cpu")
        moved, worst = 0.0, 0.0
        for k, v in gout.items():
            v = v.cpu()
            if k.startswith("hist"):
                if not torch.equal(v.sum(-1), cout[k].sum(-1)):
                    raise AssertionError(f"{k} totals: card != cpu")
                moved += float((v - cout[k]).abs().sum()) / 2
            else:
                if not torch.allclose(v, cout[k], rtol=1e-5, atol=1e-5):
                    raise AssertionError(f"tick output {k}: card != cpu")
                rel = (v - cout[k]).abs() / cout[k].abs().clamp_min(1e-5)
                worst = max(worst, float(rel.max()))
        active = int(c.state.on_active.sum() + c.state.off_active.sum())
    done("ticks", nodes=c.n, active_slots=active, samples_changed_bin=moved,
         max_rel_diff=worst)

    # 4. the main path at full width --------------------------------------
    K.launches = 0
    with timers.phase("train"):
        rf = train_default_predictor(seed=7)
        torch.cuda.synchronize()
    done("train", runqlat_hist_launches=K.launches,
         trees=int(rf.forest["feature"].shape[0]))

    fleet = make_fleet(1000, MIX, seed=0)
    pods, gaps = _arrival_trace(600, seed=7)
    ticks = 30 + sum(-(-g // cstate.CHUNK) * cstate.CHUNK for g in gaps) + 40
    sched = ICOScheduler(InterferenceQuantifier(rf.predict))
    with timers.phase("profile"):
        phase_profile(torch, c, sched, pods[:20])
    done("profile")
    torch.cuda.reset_peak_memory_stats()
    K.launches = 0
    with timers.phase("ico_1000"):
        res = run_experiment(sched, pods, gaps, fleet=fleet, seed=7)
        torch.cuda.synchronize()
    launches = K.launches
    wall = timers.totals["ico_1000"]
    done("ico_1000", nodes=fleet.num_nodes, pods=len(pods), ticks=ticks,
         avg_rt=res.avg_rt, p90_rt=res.p90_rt, p99_rt=res.p99_rt,
         placed=res.placed, rejected=res.rejected,
         queued_retries=res.queued_retries, ticks_per_s=ticks / wall,
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         runqlat_hist_launches=launches)
    if launches < 2 * ticks:
        raise AssertionError(f"{launches} kernel launches for {ticks} ticks")
    if res.placed + res.rejected != len(pods) or res.placed == 0:
        raise AssertionError(f"placed {res.placed} rejected {res.rejected}")
    if not np.isfinite([res.avg_rt, res.p90_rt, res.p99_rt]).all() or \
            not 0 < res.avg_rt <= res.p90_rt <= res.p99_rt:
        raise AssertionError(f"bad response times {res}")

    # 5. the paper-scale comparison table ---------------------------------
    with timers.phase("compare"):
        table = compare_schedulers(num_pods=40, num_nodes=12, seed=7,
                                   predictor=rf)
    for name, r in table.items():
        say("compare", scheduler=name, avg_rt=r.avg_rt, p90_rt=r.p90_rt,
            p99_rt=r.p99_rt, cpu_util_std=r.cpu_util_std,
            mem_util_std=r.mem_util_std, placed=r.placed, rejected=r.rejected)
        if r.placed + r.rejected != 40 or not np.isfinite(r.avg_rt):
            raise AssertionError(f"{name}: {r}")
    done("compare")

    # 6. a 12-node ICO run on the card and on the CPU, one noise stream ----
    with timers.phase("card_vs_cpu"):
        pods12, gaps12 = _arrival_trace(40, seed=7)
        chunks = 3 + sum(-(-g // cstate.CHUNK) for g in gaps12) + 4
        gen = torch.Generator(device=card).manual_seed(11)
        stream = [cstate.draw_noise(gen, 12, cstate.CHUNK)
                  for _ in range(chunks)]
        rf_cpu = copy.copy(rf)
        rf_cpu.device = cpu
        rf_cpu.forest = {k: v.cpu() for k, v in rf.forest.items()}
        on_card = run_experiment(
            ICOScheduler(InterferenceQuantifier(rf.predict)), pods12, gaps12,
            seed=7, noise=stream)
        on_cpu = run_experiment(
            ICOScheduler(InterferenceQuantifier(rf_cpu.predict)), pods12,
            gaps12, seed=7, device=cpu,
            noise=[[to(cpu, n) for n in ch] for ch in stream])
        a, b = dataclasses.asdict(on_card), dataclasses.asdict(on_cpu)
        if (a["placed"], a["rejected"]) != (b["placed"], b["rejected"]):
            raise AssertionError(f"card {a} != cpu {b}")
        for f in ("avg_rt", "p90_rt", "p99_rt"):
            if not np.isclose(a[f], b[f], rtol=1e-4):
                raise AssertionError(f"{f}: card {a[f]} != cpu {b[f]}")
    done("card_vs_cpu", placed=a["placed"], rejected=a["rejected"],
         avg_rt_card=a["avg_rt"], avg_rt_cpu=b["avg_rt"])

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip()
    print(smi)
    print(json.dumps({"kernels": [{
        "name": "runqlat_hist", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/runqlat_hist.cu",
        "replaces": "src/repro/kernels/runqlat_hist.py:48",
        "launches": launches, "max_abs_err": knums["max_abs_err"],
        "ms": knums["ms"], "plain_ms": knums["plain_ms"],
        "bound_ms": knums["bound_ms"], "bound_by": "bytes",
        "library_ms": knums["library_ms"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
