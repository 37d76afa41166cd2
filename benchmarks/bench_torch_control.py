"""The PyTorch port's runtime-mitigation benchmark: per-scheduler profiles,
the proactive forecast channel and the batched plan replay, on bursty
offline load, as ``name,us_per_call,derived`` rows.

The port's counterpart of ``bench_control``, on the same traces, seeds and
row names (prefixed ``torch.``):

* **Profile grid** (always): every scheduler (ICO / RR / HUP / LQP)
  without and with a fresh ``ControlLoop`` built from its tuned profile,
  12 nodes, ``bursty_trace(num_online=14)`` at each (trace seed, sim seed)
  of ``[(0, 11), (1, 12)]`` (``--full`` adds ``(2, 13)``).  The bar:
  ICO+control beats ICO at every seed.
* **Proactive axis** (``--proactive``): ICO off / reactive / proactive and
  the unified stack (ICO-F admission and the proactive loop sharing one
  ``ForecastService``) on the 3-day ``PROACTIVE_TRACE`` with the loop
  stepped every ``CONTROL_WINDOW`` ticks: p99 per mode, proactive flags
  and actions, the forecaster's one-step calibration error.
* **Batched axis** (always): one 3-day ICO trace (light linear predictor)
  run for sim seeds 11 and 12 on the per-window loop, then its plans
  without and with a reactive loop replayed under 20 seeds in one
  ``replay_plan_batched(use_fused=True)`` call each: wall clocks, p99
  mean/std per mode, wins, and the replay entry of seed 11 held to the
  run.  JAX's ``legacy_baseline`` row times its pre-change gamma sampler
  in a subprocess; that sampler never existed in the port, so the row has
  no counterpart here.

``--trace [PATH]`` (with ``--proactive``) records the first seed's unified
run and checks the Planned -> Executed -> Verified/Discarded chain of
every executed action from the trace alone (``chain_ok``); query the file
with ``python -m repro_torch.obs.explain PATH``.  ``--json [PATH]`` dumps
the grid.  ``--device`` picks where the port runs (default: the CUDA
card).  Times are host clock around work that ends in a device drain.

    PYTHONPATH=src python benchmarks/bench_torch_control.py --device cpu
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.cluster.experiment import (
    bursty_trace,
    make_schedulers,
    replay_plan_batched,
    run_experiment,
    train_default_predictor,
)
from repro_torch.control import (
    ControlLoop,
    ForecastService,
    scheduler_loop_config,
)
from repro_torch.core import ICOScheduler, InterferenceQuantifier
from repro_torch.device import resolve_device
from repro_torch.obs import Trace, TraceRecorder
from repro_torch.obs.explain import action_chains

SCHEDULERS = ("ICO", "RR", "HUP", "LQP")
SEEDS = [(0, 11), (1, 12)]
FULL_SEEDS = SEEDS + [(2, 13)]
# >= 3 diurnal periods: the leverage gate opens after ~0.9 of one
PROACTIVE_TRACE = dict(num_online=14, burst_gap=(140, 210), days=3.0)
CONTROL_WINDOW = 40
BATCHED_SIM_SEEDS = tuple(range(20))
MODES = ("off", "reactive", "proactive", "unified")


def _mean(xs):
    return sum(xs) / len(xs)


def _std(xs):
    return _mean([(x - _mean(xs)) ** 2 for x in xs]) ** 0.5


def grid_seed(predictor, trace_seed: int, sim_seed: int, *, device,
              plans: dict | None = None) -> dict:
    """One seed of the profile grid: ``{(name, with_control): (result,
    loop, wall_s)}``.  ``plans`` receives ICO's replayable plans, keyed by
    ``with_control``."""
    pods, gaps = bursty_trace(num_online=14, seed=trace_seed)
    out = {}
    for with_control in (False, True):
        # fresh schedulers per mode: RR's rotation must not leak
        for name, sched in make_schedulers(predictor).items():
            loop = (ControlLoop(InterferenceQuantifier(predictor.predict),
                                scheduler_loop_config(name))
                    if with_control else None)
            plan = (plans.setdefault(with_control, {})
                    if plans is not None and name == "ICO" else None)
            t0 = time.perf_counter()
            r = run_experiment(sched, pods, gaps, num_nodes=12, seed=sim_seed,
                               control_loop=loop, plan_out=plan,
                               device=device)
            out[(name, with_control)] = (r, loop, time.perf_counter() - t0)
    return out


def profile_grid(predictor, seeds, out, json_doc, *, device) -> dict:
    runs = {seed: grid_seed(predictor, *seed, device=device)
            for seed in seeds}
    for name in SCHEDULERS:
        on = [runs[s][(name, True)][0] for s in seeds]
        off = [runs[s][(name, False)][0] for s in seeds]
        p99_off, p99_on = _mean([r.p99_rt for r in off]), _mean(
            [r.p99_rt for r in on])
        us = _mean([runs[s][(name, c)][2] for s in seeds
                    for c in (False, True)]) * 1e6
        out.append((
            f"torch.control.grid.{name}", us,
            f"p99_off={p99_off:.2f};p99_on={p99_on:.2f};"
            f"avg_off={_mean([r.avg_rt for r in off]):.2f};"
            f"avg_on={_mean([r.avg_rt for r in on]):.2f};"
            f"mitigations={sum(r.mitigations for r in on)};"
            f"p99_gain={(1 - p99_on / p99_off) * 100:+.1f}%"))
    for trace_seed, sim_seed in seeds:
        for name in ("ICO", "RR", "HUP"):
            off = runs[(trace_seed, sim_seed)][(name, False)][0]
            on = runs[(trace_seed, sim_seed)][(name, True)][0]
            verdict = (f"win={on.p99_rt < off.p99_rt}" if name == "ICO"
                       else f"non_harmful={on.p99_rt <= off.p99_rt}")
            row = ("ICO" if name == "ICO" else f"profile.{name}")
            out.append((f"torch.control.{row}.seed{trace_seed}", 0.0,
                        f"p99_off={off.p99_rt:.2f};p99_on={on.p99_rt:.2f};"
                        f"{verdict}"))
    loops = [runs[s][(n, True)][1] for s in seeds for n in SCHEDULERS]
    predicted = sum(lp.stats.predicted_reduction for lp in loops)
    realized = sum(lp.stats.realized_reduction for lp in loops)
    corrections: dict[str, list] = {}
    for lp in loops:
        for kind, c in lp.corrections.items():
            corrections.setdefault(kind, []).append(c)
    rel_err = abs(realized - predicted) / max(predicted, 1e-9)
    out.append(("torch.control.calibration", 0.0,
                f"predicted={predicted:.1f};realized={realized:.1f};"
                f"rel_err={rel_err:.2f};"
                + ";".join(f"corr_{k}={_mean(v):.2f}"
                           for k, v in sorted(corrections.items()))))
    json_doc["grid"] = {
        name: {mode: [{"p99_rt": runs[s][(name, c)][0].p99_rt,
                       "avg_rt": runs[s][(name, c)][0].avg_rt,
                       "mitigations": runs[s][(name, c)][0].mitigations,
                       "placed": runs[s][(name, c)][0].placed,
                       "rejected": runs[s][(name, c)][0].rejected}
                      for s in seeds]
               for mode, c in (("off", False), ("on", True))}
        for name in SCHEDULERS}
    json_doc["calibration"] = {"predicted": predicted, "realized": realized,
                               "rel_err": rel_err}
    return runs


def chain_check(trace: Trace) -> dict:
    """Every executed action has a Planned event, and every non-proactive
    one whose next window elapsed a Verified/Discarded resolution."""
    executed = [c for c in action_chains(trace) if c["executed"] is not None]
    last_w = trace.last_window()
    missing_planned = [c["action_id"] for c in executed
                       if c["planned"] is None]
    missing_verified = [c["action_id"] for c in executed
                        if not c["executed"].proactive
                        and c["executed"].window < last_w
                        and c["verified"] is None]
    return {"executed": len(executed), "missing_planned": missing_planned,
            "missing_verified": missing_verified,
            "chain_ok": not missing_planned and not missing_verified}


def proactive_seed(predictor, trace_seed: int, sim_seed: int, *, device,
                   trace_path: str | None = None,
                   trace: dict = PROACTIVE_TRACE) -> dict:
    """One seed of the proactive axis: per mode the result, the loop, the
    shared service (unified only) and the wall time; with ``trace_path``
    the unified run is traced, saved and chain-checked.  ``trace`` holds
    ``bursty_trace``'s arguments."""
    pods, gaps = bursty_trace(seed=trace_seed, **trace)
    row = {"trace_seed": trace_seed, "sim_seed": sim_seed, "runs": {}}
    for mode in MODES:
        sched_name = "ICO-F" if mode == "unified" else "ICO"
        sched = make_schedulers(predictor, forecast=True)[sched_name]
        cfg = scheduler_loop_config(
            sched_name, proactive=mode in ("proactive", "unified"))
        svc = (ForecastService(cfg.forecast, cfg.horizon, device=device)
               if mode == "unified" else None)
        loop = (None if mode == "off" else ControlLoop(
            InterferenceQuantifier(predictor.predict), cfg,
            forecast_service=svc))
        rec = (TraceRecorder() if trace_path and mode == "unified"
               else None)
        t0 = time.perf_counter()
        r = run_experiment(sched, pods, gaps, num_nodes=12, seed=sim_seed,
                           control_loop=loop, forecast=svc,
                           control_window=CONTROL_WINDOW, recorder=rec,
                           device=device)
        row["runs"][mode] = (r, loop, svc, time.perf_counter() - t0)
        if rec is not None:
            row["trace"] = {"path": trace_path,
                            "events": rec.save(trace_path),
                            "trust_gate_events": len(rec.query(
                                "trust_gate")),
                            **chain_check(Trace(rec.events))}
    return row


def proactive_axis(predictor, seeds, out, json_doc, trace_path=None, *,
                   device) -> list:
    rows, fcals = [], []
    for i, seed in enumerate(seeds):
        row = proactive_seed(predictor, *seed, device=device,
                             trace_path=trace_path if i == 0 else None)
        rows.append(row)
        runs = row["runs"]
        pro_loop = runs["proactive"][1]
        fcal = pro_loop.forecaster.calibration_error()
        fcals.append(fcal)
        p99 = {m: runs[m][0].p99_rt for m in MODES}
        out.append((
            f"torch.control.proactive.ICO.seed{seed[0]}", 0.0,
            ";".join(f"p99_{m}={p99[m]:.2f}" for m in MODES)
            + f";pro_flags={pro_loop.stats.proactive_flagged}"
            f";pro_actions={runs['proactive'][0].proactive_mitigations}"
            f";win={p99['proactive'] <= p99['reactive']}"))
        if "trace" in row:
            t = row["trace"]
            out.append(("torch.control.trace", 0.0,
                        f"path={t['path']};events={t['events']};"
                        f"executed={t['executed']};chain_ok={t['chain_ok']}"))
            json_doc["trace"] = t
    means = {m: _mean([r["runs"][m][0].p99_rt for r in rows]) for m in MODES}
    out.append((
        "torch.control.proactive.summary", 0.0,
        ";".join(f"mean_p99_{m}={means[m]:.2f}" for m in MODES)
        + f";proactive_beats_reactive={means['proactive'] <= means['reactive']}"
        f";forecast_calibration={_mean(fcals):.3f}"))
    json_doc["proactive"] = {
        "control_window": CONTROL_WINDOW, "trace": PROACTIVE_TRACE,
        "rows": [{"trace_seed": r["trace_seed"], "sim_seed": r["sim_seed"],
                  **{m: {"p99_rt": r["runs"][m][0].p99_rt,
                         "avg_rt": r["runs"][m][0].avg_rt,
                         "mitigations": r["runs"][m][0].mitigations,
                         "proactive_mitigations":
                             r["runs"][m][0].proactive_mitigations}
                     for m in MODES}} for r in rows],
        "mean_p99": means, "forecast_calibration": _mean(fcals)}
    return rows


def batched_axis(out, json_doc, *, device, sim_seeds=BATCHED_SIM_SEEDS):
    """Two seeds on the per-window loop against 20 replayed at once, on one
    3-day ICO trace, without and with reactive mitigation."""
    pods, gaps = bursty_trace(seed=0, **PROACTIVE_TRACE)
    ref_seed = 11
    quantify = InterferenceQuantifier(lambda x: x[:, 0] * 0.1)
    plan_off: dict = {}
    baseline = []
    t0 = time.perf_counter()
    for i, sim_seed in enumerate((ref_seed, ref_seed + 1)):
        baseline.append(run_experiment(
            ICOScheduler(quantify), pods, gaps, num_nodes=12, seed=sim_seed,
            control_window=CONTROL_WINDOW,
            plan_out=plan_off if i == 0 else None, device=device))
    loop_wall = time.perf_counter() - t0
    plan_on: dict = {}
    run_experiment(ICOScheduler(quantify), pods, gaps, num_nodes=12,
                   seed=ref_seed,
                   control_loop=ControlLoop(quantify,
                                            scheduler_loop_config("ICO")),
                   control_window=CONTROL_WINDOW, plan_out=plan_on,
                   device=device)
    reps = {mode: replay_plan_batched(plan, sim_seeds=sim_seeds,
                                      window_ticks=CONTROL_WINDOW,
                                      use_fused=True, device=device)
            for mode, plan in (("off", plan_off), ("on", plan_on))}
    p99 = {m: [e["p99_rt"] for e in reps[m]["seeds"]] for m in reps}
    wins = sum(on < off for on, off in zip(p99["on"], p99["off"]))
    ref = next(e for e in reps["off"]["seeds"] if e["sim_seed"] == ref_seed)
    parity = abs(ref["p99_rt"] - baseline[0].p99_rt) / max(
        baseline[0].p99_rt, 1e-9)
    wall = reps["off"]["wall_s"]
    out += [
        ("torch.control.batched.python_loop", loop_wall * 1e6,
         f"seeds=2;wall_s={loop_wall:.1f};"
         f"p99={_mean([r.p99_rt for r in baseline]):.2f}"),
        ("torch.control.batched.vmap", wall * 1e6,
         f"seeds={len(sim_seeds)};wall_off_s={wall:.1f};"
         f"wall_on_s={reps['on']['wall_s']:.1f};"
         f"windows={reps['off']['num_windows']};"
         f"per_seed_s={wall / len(sim_seeds):.2f}"),
        ("torch.control.batched.speedup", 0.0,
         f"per_seed_loop_s={loop_wall / 2:.2f};"
         f"per_seed_batched_s={wall / len(sim_seeds):.2f};"
         f"speedup={loop_wall / 2 / max(wall / len(sim_seeds), 1e-9):.1f}x"),
        ("torch.control.batched.parity", 0.0,
         f"ref_p99={baseline[0].p99_rt:.2f};replay_p99={ref['p99_rt']:.2f};"
         f"rel_diff={parity:.4f};parity_ok={parity < 0.01}"),
        ("torch.control.batched.winloss", 0.0,
         f"p99_off={_mean(p99['off']):.2f}+/-{_std(p99['off']):.2f};"
         f"p99_on={_mean(p99['on']):.2f}+/-{_std(p99['on']):.2f};"
         f"wins={wins}/{len(sim_seeds)}"),
    ]
    json_doc["batched"] = {
        "sim_seeds": list(sim_seeds), "trace": PROACTIVE_TRACE,
        "loop_wall_s": loop_wall, "batched_wall_off_s": wall,
        "batched_wall_on_s": reps["on"]["wall_s"], "wins": int(wins),
        "p99_off": p99["off"], "p99_on": p99["on"],
        "parity_rel_diff": parity, "parity_ok": parity < 0.01}
    return reps


def run(fast: bool = True, json_path: str | None = None,
        proactive: bool = False, trace_path: str | None = None,
        device=None) -> list:
    device = resolve_device(device)
    seeds = SEEDS if fast else FULL_SEEDS
    predictor = train_default_predictor(
        seed=7, num_placements=80 if fast else 250, device=device)
    out: list = []
    json_doc: dict = {"seeds": seeds, "fast": fast, "device": str(device)}
    if device.type == "cuda":
        json_doc["card"] = torch.cuda.get_device_name(device)
    profile_grid(predictor, seeds, out, json_doc, device=device)
    batched_axis(out, json_doc, device=device)
    if proactive:
        proactive_axis(predictor, seeds, out, json_doc,
                       trace_path=trace_path, device=device)
    if json_path:
        with open(json_path, "w") as f:
            json.dump(json_doc, f, indent=2)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--full", action="store_true",
                    help="three seeds and the 250-placement forest")
    ap.add_argument("--proactive", action="store_true",
                    help="add the proactive axis (3-day traces)")
    ap.add_argument("--json", nargs="?", const="BENCH_torch_control.json",
                    default=None, help="dump the grid as JSON")
    ap.add_argument("--trace", nargs="?",
                    const="BENCH_torch_control_trace.jsonl", default=None,
                    help="trace the first unified run (with --proactive)")
    args = ap.parse_args()
    print("name,us_per_call,derived")
    for name, us, derived in run(fast=not args.full, json_path=args.json,
                                 proactive=args.proactive,
                                 trace_path=args.trace, device=args.device):
        print(f"{name},{us:.1f},{derived}")


if __name__ == "__main__":
    main()
