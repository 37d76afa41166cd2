"""The PyTorch port's Figs. 13-15 benchmark: ICO vs RR / HUP / LQP, online
response times (avg / p90 / p99) and cross-node CPU / MEM utilization std
on identical traces, as ``name,us_per_call,derived`` rows.

The port's counterpart of ``bench_schedulers``, on the same traces, seeds
and row names (prefixed ``torch.``):

* **Headline** (always): ``compare_schedulers(num_pods=40, num_nodes=12,
  seed=7)`` (90 pods with ``--full``), every scheduler against HUP.
* **Batched axis** (always): each scheduler's plan on the headline trace
  replayed under the 20 ``BATCHED_SIM_SEEDS`` in one
  ``replay_plan_batched`` call: p99 and avg mean +/- std, and per-seed wins
  against HUP.
* **Forecast axis** (``--forecast``): ICO against ICO-F with a fresh
  ``ForecastService`` on the 3-day ``FORECAST_TRACE`` at each of
  ``FORECAST_SEEDS``; on the first seed ICO-F without a service must equal
  ICO (``fallback_exact``: p99 and placed bit for bit).  Day-scale traces
  are needed: the forecaster's leverage gate opens only after ~0.9 of a
  diurnal period.

``--trace [PATH]`` (with ``--forecast``) records the first seed's ICO-F run
through a ``repro_torch.obs.TraceRecorder``; read the file with ``python -m
repro_torch.obs.explain PATH``.  ``--json [PATH]`` dumps the headline, the
batched axis and the forecast axis.

Predictors, as in JAX's bench: the headline uses ``compare_schedulers``'
default forest (250 placements); the batched and forecast axes train their
own (``train_default_predictor(seed=7)``, 80 placements, 250 with
``--full``).  ``run(predictor=)`` passes one forest to every axis instead;
the batched axis then replays the headline runs' own plans, so each
scheduler's entry under sim seed 7 is its headline run.

On the card every replay runs the fused tick (``use_fused=True``: one
``rollout_tick`` launch a batched tick); on the CPU the tick's plain
version.  ``--device`` picks where the port runs (default: the CUDA card;
``--device cpu`` the CPU).  Times are host clock around work that ends in
a device drain.  The axis functions take an optional per-seed noise
factory ``noise(seed, num_nodes)`` that replaces the port's generator
(the tests inject JAX's draws with it).

    PYTHONPATH=src python benchmarks/bench_torch_schedulers.py --device cpu
"""
from __future__ import annotations

import argparse
import json
import time

from repro_torch.cluster.experiment import (
    _arrival_trace,
    bursty_trace,
    compare_schedulers,
    make_schedulers,
    replay_plan_batched,
    run_experiment,
    train_default_predictor,
)
from repro_torch.control import ForecastService
from repro_torch.device import resolve_device, sync
from repro_torch.obs import TraceRecorder

# day-scale bursty traces for the ICO-F axis: an online fleet and recurring
# offline waves over >= 3 diurnal periods, so late bursts are admitted
# with the trust gate open
FORECAST_TRACE = dict(num_online=14, burst_gap=(140, 210), days=3.0)
FORECAST_SEEDS = [(0, 11), (1, 12)]
CONTROL_WINDOW = 40  # forecast-observation cadence inside day-scale gaps

# seed axis of the plan replay (>= 20 telemetry streams a plan)
BATCHED_SIM_SEEDS = tuple(range(20))

NUM_NODES, TRACE_SEED = 12, 7


def _mean(xs):
    return sum(xs) / len(xs)


def _std(xs):
    m = _mean(xs)
    return (_mean([(x - m) ** 2 for x in xs])) ** 0.5


def _stream(noise, seed):
    """One run's tick-noise stream (None: the cluster's own generator)."""
    return None if noise is None else noise(seed, NUM_NODES)


def headline(out, json_doc, n_pods: int, *, device, predictor=None,
             noise=None, plans: dict | None = None) -> dict:
    """Figs. 13-15: ``compare_schedulers`` on the seed-7 trace.  ``plans``
    receives each run's replayable plan."""
    sync(device)
    t0 = time.perf_counter()
    res = compare_schedulers(
        num_pods=n_pods, num_nodes=NUM_NODES, seed=TRACE_SEED,
        predictor=predictor, device=device, plans_out=plans,
        noise=None if noise is None else (
            lambda: _stream(noise, TRACE_SEED)))
    sync(device)
    total_us = (time.perf_counter() - t0) * 1e6
    base = res["HUP"]
    for name, r in res.items():
        rel = (1 - r.avg_rt / base.avg_rt) * 100 if base.avg_rt else 0.0
        out.append((
            f"torch.schedulers.{name}",
            total_us / len(res),
            f"avg_rt={r.avg_rt:.2f};p90={r.p90_rt:.2f};p99={r.p99_rt:.2f};"
            f"cpu_std={r.cpu_util_std:.2f};mem_std={r.mem_util_std:.2f};"
            f"placed={r.placed};vs_hup_avg={rel:+.1f}%",
        ))
        json_doc["schedulers"][name] = {
            "avg_rt": r.avg_rt, "p90_rt": r.p90_rt, "p99_rt": r.p99_rt,
            "cpu_util_std": r.cpu_util_std, "mem_util_std": r.mem_util_std,
            "placed": r.placed, "rejected": r.rejected,
        }
    return res


def batched_axis(out, json_doc, predictor, n_pods: int, *, device,
                 sim_seeds=BATCHED_SIM_SEEDS, noise=None,
                 plans: dict | None = None) -> dict:
    """Replay every scheduler's plan under ``sim_seeds`` at once: the
    ranking with error bars and a per-seed win/loss record against HUP.
    A scheduler whose plan ``plans`` holds is not rerun."""
    pods, gaps = _arrival_trace(n_pods, seed=TRACE_SEED)
    per_sched: dict[str, dict] = {}
    for name, sched in make_schedulers(predictor).items():
        plan = (plans or {}).get(name)
        if plan is None:
            plan = {}
            run_experiment(sched, pods, gaps, num_nodes=NUM_NODES,
                           seed=TRACE_SEED, plan_out=plan, device=device,
                           noise=_stream(noise, TRACE_SEED))
        batch = replay_plan_batched(
            plan, sim_seeds=sim_seeds, use_fused=True, device=device,
            noise=None if noise is None else [_stream(noise, s)
                                              for s in sim_seeds])
        per_sched[name] = {
            "p99": [e["p99_rt"] for e in batch["seeds"]],
            "avg": [e["avg_rt"] for e in batch["seeds"]],
            "wall_s": batch["wall_s"], "replay": batch,
        }
    hup = per_sched["HUP"]["p99"]
    json_doc["batched"] = {"sim_seeds": [int(s) for s in sim_seeds],
                           "schedulers": {}}
    for name, d in per_sched.items():
        wins = sum(p < h for p, h in zip(d["p99"], hup))
        d["wins_vs_hup"] = int(wins)
        out.append((
            f"torch.schedulers.batched.{name}",
            d["wall_s"] * 1e6,
            f"seeds={len(sim_seeds)};"
            f"p99={_mean(d['p99']):.2f}+/-{_std(d['p99']):.2f};"
            f"avg={_mean(d['avg']):.2f}+/-{_std(d['avg']):.2f};"
            f"wins_vs_hup={wins}/{len(sim_seeds)}",
        ))
        json_doc["batched"]["schedulers"][name] = {
            "p99_mean": _mean(d["p99"]), "p99_std": _std(d["p99"]),
            "avg_mean": _mean(d["avg"]), "avg_std": _std(d["avg"]),
            "p99_per_seed": d["p99"],
            "wins_vs_hup": int(wins),
            "losses_vs_hup": int(len(sim_seeds) - wins),
            "wall_s": d["wall_s"],
        }
    return per_sched


def forecast_seed(predictor, trace_seed: int, sim_seed: int, *, device,
                  trace: dict = FORECAST_TRACE, config=None, recorder=None,
                  noise=None, ico: bool = True) -> dict:
    """One seed of the forecast axis on ``bursty_trace(seed=trace_seed,
    **trace)``: ICO (unless ``ico`` is false) and ICO-F with a fresh
    ``ForecastService(config)`` observing every ``CONTROL_WINDOW`` ticks.
    Returns the trace, both results, the service and the wall time."""
    pods, gaps = bursty_trace(seed=trace_seed, **trace)
    scheds = make_schedulers(predictor, forecast=True)
    row = {"pods": pods, "gaps": gaps}
    sync(device)
    t0 = time.perf_counter()
    if ico:
        row["ico"] = run_experiment(scheds["ICO"], pods, gaps,
                                    num_nodes=NUM_NODES, seed=sim_seed,
                                    device=device,
                                    noise=_stream(noise, sim_seed))
    svc = ForecastService(config, device=device)
    row["icof"] = run_experiment(
        scheds["ICO-F"], pods, gaps, num_nodes=NUM_NODES, seed=sim_seed,
        forecast=svc, control_window=CONTROL_WINDOW, recorder=recorder,
        device=device, noise=_stream(noise, sim_seed))
    sync(device)
    row["wall_s"] = time.perf_counter() - t0
    row["service"] = svc
    return row


def fallback_exact(predictor, pods, gaps, sim_seed: int, ico_result, *,
                   device, noise=None) -> bool:
    """ICO-F without a service is ICO: p99 and placed bit for bit."""
    r_fb = run_experiment(
        make_schedulers(predictor, forecast=True)["ICO-F"], pods, gaps,
        num_nodes=NUM_NODES, seed=sim_seed, device=device,
        noise=_stream(noise, sim_seed))
    return (r_fb.p99_rt == ico_result.p99_rt
            and r_fb.placed == ico_result.placed)


def forecast_axis(out, json_doc, predictor, *, device,
                  trace_path: str | None = None, seeds=FORECAST_SEEDS,
                  trace: dict = FORECAST_TRACE, config=None,
                  noise=None) -> list:
    """ICO vs ICO-F at each of ``seeds``; the first seed's ICO-F run traced
    to ``trace_path`` when given, and held to the exact-fallback bar."""
    rows = []
    for i, (trace_seed, sim_seed) in enumerate(seeds):
        rec = TraceRecorder() if trace_path and i == 0 else None
        row = forecast_seed(predictor, trace_seed, sim_seed, device=device,
                            trace=trace, config=config, recorder=rec,
                            noise=noise)
        r_ico, r_icof = row["ico"], row["icof"]
        if rec is not None:
            n_events = rec.save(trace_path)
            out.append((
                "torch.schedulers.forecast.trace", 0.0,
                f"path={trace_path};events={n_events};"
                f"admissions={len(rec.query('admission'))}",
            ))
        if i == 0:
            row["fallback_exact"] = fallback_exact(
                predictor, row["pods"], row["gaps"], sim_seed, r_ico,
                device=device, noise=noise)
        rows.append(row)
        out.append((
            f"torch.schedulers.forecast.seed{trace_seed}",
            row["wall_s"] * 1e6,
            f"p99_ico={r_ico.p99_rt:.2f};p99_icof={r_icof.p99_rt:.2f};"
            f"avg_ico={r_ico.avg_rt:.2f};avg_icof={r_icof.avg_rt:.2f};"
            f"win={r_icof.p99_rt <= r_ico.p99_rt}"
            + (f";fallback_exact={row['fallback_exact']}"
               if "fallback_exact" in row else ""),
        ))
    mean_ico = _mean([r["ico"].p99_rt for r in rows])
    mean_icof = _mean([r["icof"].p99_rt for r in rows])
    out.append((
        "torch.schedulers.forecast.summary", 0.0,
        f"mean_p99_ico={mean_ico:.2f};mean_p99_icof={mean_icof:.2f};"
        f"icof_beats_ico={mean_icof <= mean_ico}",
    ))
    json_doc["forecast"] = {
        "trace": dict(trace), "control_window": CONTROL_WINDOW,
        "rows": [{"seeds": list(s),
                  **{k: {"p99_rt": r[k].p99_rt, "avg_rt": r[k].avg_rt,
                         "placed": r[k].placed, "rejected": r[k].rejected}
                     for k in ("ico", "icof")},
                  **({"fallback_exact": r["fallback_exact"]}
                     if "fallback_exact" in r else {})}
                 for s, r in zip(seeds, rows)],
        "mean_p99_ico": mean_ico, "mean_p99_icof": mean_icof}
    return rows


def run(fast: bool = True, forecast: bool = False,
        trace_path: str | None = None, json_path: str | None = None, *,
        device=None, predictor=None) -> list:
    device = resolve_device(device)
    n_pods = 40 if fast else 90
    out: list = []
    json_doc: dict = {"fast": fast, "device": str(device), "schedulers": {}}
    plans = {} if predictor is not None else None
    headline(out, json_doc, n_pods, device=device, predictor=predictor,
             plans=plans)
    axis_predictor = predictor or train_default_predictor(
        seed=TRACE_SEED, num_placements=80 if fast else 250, device=device)
    batched_axis(out, json_doc, axis_predictor, n_pods, device=device,
                 plans=plans)
    if forecast:
        forecast_axis(out, json_doc, axis_predictor, device=device,
                      trace_path=trace_path)
    if json_path:
        with open(json_path, "w") as f:
            json.dump(json_doc, f, indent=2)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--full", action="store_true",
                    help="90 pods and the 250-placement forest")
    ap.add_argument("--forecast", action="store_true",
                    help="add the ICO vs ICO-F axis (3-day traces)")
    ap.add_argument("--json", nargs="?", const="BENCH_torch_schedulers.json",
                    default=None, help="dump the results as JSON")
    ap.add_argument("--trace", nargs="?",
                    const="BENCH_torch_schedulers_trace.jsonl", default=None,
                    help="trace the first ICO-F run (with --forecast)")
    args = ap.parse_args()
    print("name,us_per_call,derived")
    for name, us, derived in run(fast=not args.full, forecast=args.forecast,
                                 trace_path=args.trace, json_path=args.json,
                                 device=args.device):
        print(f"{name},{us:.1f},{derived}")


if __name__ == "__main__":
    main()
