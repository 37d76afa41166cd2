"""End-to-end scheduler comparison -- reproduces Figs. 13-15.

Port of ``repro.cluster.experiment``: runs identical pod-arrival traces
under ICO / RR / HUP / LQP (and ICO-F when asked) and reports online
avg/p90/p99 response time plus cross-node CPU/MEM utilization spread.
Rejected pods wait in a bounded retry queue, per Algorithm 1.
``run_experiment(control_loop=)`` steps a ``repro_torch.control.ControlLoop``
after every rollout window (mitigation on/off reruns); ``forecast=``
threads a ``ForecastService`` through the admission snapshots (and, when
the loop was built with the same instance, the loop); ``recorder=`` traces
the whole run.

``run_experiment(plan_out=...)`` records a run's placement plan, and
``replay_plan_batched`` re-evaluates that plan under many simulation seeds
in one batched rollout (common-random-placements replay).

The simulation runs on the cluster's device; response-time samples stay
there until the end of the run, when the statistics are taken on the host
with numpy exactly as the JAX driver takes them.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque

import numpy as np
import torch

from repro_torch.cluster import state as cstate
from repro_torch.cluster import workloads as W
from repro_torch.cluster.dataset import _random_pod, generate_latency_dataset
from repro_torch.cluster.simulator import Cluster
from repro_torch.cluster.state import TICKS_PER_DAY
from repro_torch.cluster.workloads import Pod
from repro_torch.core import (
    HUPScheduler,
    ICOFScheduler,
    ICOScheduler,
    InterferenceQuantifier,
    LQPScheduler,
    RoundRobinScheduler,
    SchedulerConfig,
)
from repro_torch.core.predictors import RandomForestRegressor
from repro_torch.device import resolve_device, sync
from repro_torch.obs import PhaseTimers, PhaseTimings, RetryDrained, RetryQueued


@dataclasses.dataclass
class ExperimentResult:
    scheduler: str
    avg_rt: float
    p90_rt: float
    p99_rt: float
    cpu_util_std: float
    mem_util_std: float
    placed: int
    rejected: int
    queued_retries: int = 0   # placements that succeeded via the retry queue
    mitigations: int = 0      # control-loop actions applied DURING THIS RUN
    proactive_mitigations: int = 0    # subset planned from forecast drift
    predicted_reduction: float = 0.0  # cost-model claim for this run's actions
    realized_reduction: float = 0.0   # what post-action verification observed


def train_default_predictor(seed: int = 0, num_placements: int = 250, *,
                            device=None):
    """Train the production Random Forest used by Eq. (3)."""
    device = resolve_device(device)
    X, y = generate_latency_dataset(num_placements=num_placements, seed=seed,
                                    device=device)
    return RandomForestRegressor(n_estimators=30, max_depth=10, seed=seed,
                                 device=device).fit(X, y)


def make_schedulers(predictor, cfg: SchedulerConfig | None = None,
                    forecast: bool = False):
    """The Figs. 13-15 scheduler set; ``forecast=True`` adds ICO-F (opt-in:
    without a ``ForecastService`` it scores exactly as ICO)."""
    cfg = cfg or SchedulerConfig()
    q = InterferenceQuantifier(predictor.predict)
    out = {
        "ICO": ICOScheduler(q, cfg),
        "RR": RoundRobinScheduler(cfg),
        "HUP": HUPScheduler(q, cfg),
        "LQP": LQPScheduler(cfg),
    }
    if forecast:
        out["ICO-F"] = ICOFScheduler(q, cfg)
    return out


def _arrival_trace(num_pods: int, seed: int):
    """Pre-generate an identical pod sequence for every scheduler."""
    rng = np.random.default_rng(seed)
    pods, gaps = [], []
    for _ in range(num_pods):
        pods.append(_random_pod(rng))
        gaps.append(int(rng.integers(5, 25)))  # ticks between submissions
    return pods, gaps


def bursty_trace(
    num_online: int = 24,
    num_bursts: int = 5,
    jobs_per_burst: int = 4,
    seed: int = 0,
    burst_gap: tuple = (30, 60),
    job_duration: tuple = (120, 240),
    days: float | None = None,
):
    """A stable online fleet, then recurring waves of heavy short offline
    jobs (the runtime-mitigation scenario).  ``days`` raises
    ``num_bursts`` until the expected span covers that many diurnal
    periods."""
    rng = np.random.default_rng(seed)
    if days is not None:
        online_span = num_online * 5.0          # mean of the (3, 8) gaps
        per_burst = 2 * (jobs_per_burst - 1) + sum(burst_gap) / 2.0
        num_bursts = max(num_bursts, int(round(
            (days * TICKS_PER_DAY - online_span) / per_burst)))
    pods, gaps = [], []
    for _ in range(num_online):
        name = rng.choice(W.ONLINE_NAMES)
        prof = W.ONLINE_PROFILES[name]
        qps = float(rng.uniform(120, 500))
        pod = Pod(name, qps, True)
        pod.cpu_demand = prof.cpu_per_qps * qps + prof.cpu_base
        pod.mem_demand = prof.mem_per_qps * qps + prof.mem_base
        pods.append(pod)
        gaps.append(int(rng.integers(3, 8)))
    for _ in range(num_bursts):
        for j in range(jobs_per_burst):
            name = rng.choice(W.OFFLINE_NAMES)
            prof = W.OFFLINE_PROFILES[name]
            cores = float(prof.cores_choices[-2])
            pod = Pod(name, 0.0, False,
                      duration=int(rng.integers(*job_duration)))
            pod.cpu_demand = cores
            pod.mem_demand = cores * prof.mem_per_core
            pods.append(pod)
            gaps.append(2 if j < jobs_per_burst - 1
                        else int(rng.integers(*burst_gap)))
    return pods, gaps


def run_experiment(
    scheduler,
    pods: list[Pod],
    gaps: list[int],
    num_nodes: int = 12,
    seed: int = 7,
    settle_ticks: int = 40,
    *,
    fleet=None,
    control_loop=None,
    forecast=None,
    control_window: int | None = None,
    retry_limit: int = 8,
    retry_attempts: int = 3,
    recorder=None,
    device=None,
    noise=None,
    plan_out: dict | None = None,
) -> ExperimentResult:
    """Replay one arrival trace under a scheduler.

    fleet: optional ``repro_torch.cluster.fleet.Fleet``; when given it
        defines the node population and ``num_nodes`` is taken from it.
    control_loop: optional ``repro_torch.control.ControlLoop``, or a
        zero-argument factory returning one (a fresh loop per run).  Its
        ``step`` runs after every rollout window; the result's mitigation
        numbers are this run's deltas of the loop's lifetime stats.
    forecast: optional ``repro_torch.control.ForecastService``, or a
        zero-argument factory (a fresh service per run).  It observes every
        telemetry window and annotates the admission snapshots, so ICO-F
        admits against projected contention; pass the instance the loop
        was built with to share one projection.
    control_window: with a control loop or a forecast service, slice each
        inter-arrival rollout into windows of at most this many ticks and
        step / observe after each.  RT is sampled before every step (a
        migration frees its source slot, and sampling afterwards would drop
        the moved pod's worst window).
    retry_limit / retry_attempts: Algorithm 1's bounded retry queue.
    recorder: optional ``repro_torch.obs.TraceRecorder``: threaded into the
        scheduler (restored on exit), the loop and the service (unless they
        carry their own) and the driver (windows, retry-queue transitions,
        phase times).  Tracing only observes: the run is the same.
    device: where the simulation runs (``None`` -> the CUDA card).
    noise: optional per-chunk tick-noise stream for the cluster (see
        ``Cluster``); ``None`` draws from the cluster's generator.
    plan_out: optional dict, filled on exit with the run's replayable plan
        (the cluster's mutation log and the trace geometry) for
        ``replay_plan_batched``.
    """
    if control_loop is not None and not hasattr(control_loop, "step"):
        control_loop = control_loop()  # factory -> fresh per-run instance
    if forecast is not None and not hasattr(forecast, "observe"):
        forecast = forecast()          # factory -> fresh per-run instance
    sched_recorder_prev = getattr(scheduler, "recorder", None)
    if recorder is not None:
        if control_loop is not None and control_loop.recorder is None:
            control_loop.recorder = recorder
        if forecast is not None and forecast.recorder is None:
            forecast.recorder = recorder
        if hasattr(scheduler, "recorder"):
            scheduler.recorder = recorder
    # the loop's timers double as the driver's, so rollout and control
    # phases land in one summary; an uncontrolled run gets its own
    timers = control_loop.timers if control_loop is not None else PhaseTimers()
    stats0 = (0, 0, 0.0, 0.0)
    if control_loop is not None:
        s = control_loop.stats
        stats0 = (s.actions_applied, s.proactive_applied,
                  s.predicted_reduction, s.realized_reduction)
    cluster = Cluster(num_nodes=num_nodes, seed=seed, fleet=fleet,
                      device=device, noise=noise)
    num_nodes = cluster.n  # a fleet overrides the scalar argument
    cluster.rollout(30)
    if recorder is not None:
        recorder.begin_window(cluster.t)
    rt_all: list[torch.Tensor] = []
    cpu_series, mem_series = [], []
    placed = rejected = queued_retries = 0
    retry_q: deque[tuple[Pod, int]] = deque()  # (pod, attempts so far)
    last_view = None  # advance()'s last window view, reusable at the same t

    def snapshot():
        """One view per arrival tick, annotated with the shared projection
        when a service is attached; nothing mutates the cluster between
        advance()'s last window view and this one, so that view is reused."""
        if last_view is not None and last_view.t == cluster.t:
            view = last_view
        else:
            view = cluster.view()
        if forecast is not None:
            forecast.observe(view)   # idempotent if advance() already did
            forecast.annotate(view)
        return view

    def offer(pod: Pod, view, retry: bool = False) -> bool:
        node = scheduler.select_node(pod, view)
        ok = node >= 0 and cluster.place(pod, node)
        if recorder is not None:
            # the uid exists only after a successful place: bind it, and
            # the outcome, onto the admission the scheduler just emitted
            recorder.resolve_admission(uid=pod.uid if ok else -1,
                                       placed=ok, retry=retry)
        return ok

    def drain_retries(view) -> None:
        nonlocal placed, rejected, queued_retries
        for _ in range(len(retry_q)):
            qpod, failed = retry_q.popleft()  # failed = prior re-offers
            if offer(qpod, view, retry=True):
                placed += 1
                queued_retries += 1
                outcome, uid = "placed", qpod.uid
            elif failed + 1 >= retry_attempts:
                rejected += 1
                outcome, uid = "rejected", -1
            else:
                retry_q.append((qpod, failed + 1))
                outcome, uid = "requeued", -1
            if recorder is not None:
                recorder.emit(RetryDrained(
                    workload=qpod.workload, qps=float(qpod.qps),
                    outcome=outcome, uid=uid, attempts=failed + 1))

    def advance(ticks: int, record_util: bool = True) -> None:
        """Roll forward, sampling RT (and stepping the loop) per window.
        The settle phase records RT but not the util series (Figs. 14-15
        average balance over the arrival phase)."""
        nonlocal last_view
        stepped = control_loop is not None or forecast is not None
        while ticks > 0:
            w = ticks
            if stepped and control_window is not None:
                w = min(control_window, ticks)
            t0 = cluster.t
            with timers.phase("rollout"):
                cluster.rollout(w)
                sync(cluster.device)
            rt_all.append(cluster.online_rt_samples())
            if record_util:
                cpu_series.append(cluster.last["cpu_util"])
                mem_series.append(cluster.last["mem_util"])
            # window boundary: RT sampled, control not yet stepped -- this
            # window's hotspot and action events carry the new index
            if recorder is not None:
                recorder.begin_window(cluster.t)
            if stepped:
                with timers.phase("snapshot"):
                    view = last_view = cluster.view()
                if forecast is not None:
                    forecast.observe(view)
                if control_loop is not None and control_loop.step(
                        cluster, view=view):
                    # mitigation moved pods: the cached view predates it
                    last_view = None
            tw = timers.pop_window()
            if recorder is not None and tw:
                recorder.emit(PhaseTimings(timings=tw))
            # count the ticks actually simulated: rollout rounds up to
            # CHUNK multiples, and decrementing by the request would
            # re-simulate the overshoot and diverge from an unsliced run
            progress = int(cluster.t - t0)
            ticks -= progress if progress > 0 else w

    for pod, gap in zip(pods, gaps):
        pod = dataclasses.replace(pod)  # fresh copy per scheduler
        view = snapshot()
        drain_retries(view)
        if offer(pod, view):
            placed += 1
        elif retry_attempts > 0 and len(retry_q) < retry_limit:
            retry_q.append((pod, 0))
            if recorder is not None:
                recorder.emit(RetryQueued(workload=pod.workload,
                                          qps=float(pod.qps), attempts=0))
        else:
            rejected += 1
        advance(gap)

    drain_retries(snapshot())
    rejected += len(retry_q)  # still queued at trace end: never placed
    advance(settle_ticks, record_util=False)
    if recorder is not None and hasattr(scheduler, "recorder"):
        # schedulers are reused across runs; the trace belongs to this one
        scheduler.recorder = sched_recorder_prev

    rt = torch.cat(rt_all).cpu().numpy()
    if rt.size == 0:
        rt = np.full(1, np.nan)  # no online pod ever ran
    cpu = torch.stack(cpu_series).cpu().numpy()  # (T, N)
    mem = torch.stack(mem_series).cpu().numpy()
    mitigations, proactive, predicted, realized = 0, 0, 0.0, 0.0
    if control_loop is not None:
        s = control_loop.stats
        mitigations = s.actions_applied - stats0[0]
        proactive = s.proactive_applied - stats0[1]
        predicted = s.predicted_reduction - stats0[2]
        realized = s.realized_reduction - stats0[3]
    if plan_out is not None:
        plan_out.update(
            log=list(cluster.log),
            t_end=float(cluster.t),
            num_nodes=num_nodes,
            seed=seed,
            settle_ticks=settle_ticks,
            fleet=fleet,
        )
    return ExperimentResult(
        scheduler=scheduler.name,
        avg_rt=float(rt.mean()),
        p90_rt=float(np.percentile(rt, 90)),
        p99_rt=float(np.percentile(rt, 99)),
        cpu_util_std=float((100 * cpu).std(axis=1).mean()),
        mem_util_std=float((100 * mem).std(axis=1).mean()),
        placed=placed,
        rejected=rejected,
        queued_retries=queued_retries,
        mitigations=mitigations,
        proactive_mitigations=proactive,
        predicted_reduction=predicted,
        realized_reduction=realized,
    )


def replay_inputs(plan: dict, window_ticks: int = 40, bucket: bool = True,
                  *, device=None) -> dict:
    """What a replay of ``plan`` (a ``run_experiment`` ``plan_out``) runs
    on: the empty initial state and fleet parameters on ``device``, the
    workload profiles, the ``extract_plan`` events in windows of
    ``window_ticks``, and the geometry (``t_end``, ``num_windows``,
    ``padded_windows``, ``cpw`` chunks per window, ``span`` ticks per
    window).  A plan recorded from a fleet run carries its ``Fleet``, from
    which the same per-node capacities and delay curves are rebuilt."""
    device = resolve_device(device)
    t_end = int(round(plan["t_end"]))
    num_nodes = plan["num_nodes"]
    fleet = plan.get("fleet")
    cpw = max(1, window_ticks // cstate.CHUNK)
    num_windows = -(-(t_end // cstate.CHUNK) // cpw)
    events = cstate.extract_plan(plan["log"], 0.0, num_windows, cpw,
                                 bucket=bucket)
    if fleet is not None:
        state0 = cstate.ClusterState.create(
            num_nodes, fleet.cores(), fleet.mem_gb(), device=device)
        fleet_params = fleet.params(device=device)
    else:
        state0 = cstate.ClusterState.create(num_nodes, device=device)
        fleet_params = None  # batched_rollout defaults to uniform params
    return {
        "state": state0, "fleet": fleet_params, "events": events,
        "profiles": {k: torch.as_tensor(v, device=device)
                     for k, v in W.online_arrays().items()},
        "num_nodes": num_nodes, "t_end": t_end, "num_windows": num_windows,
        "padded_windows": events["op"].shape[0], "cpw": cpw,
        "span": cpw * cstate.CHUNK,
        "settle_ticks": plan.get("settle_ticks", 40),
    }


def replay_plan_batched(
    plan: dict,
    sim_seeds=tuple(range(20)),
    window_ticks: int = 40,
    bucket: bool = True,
    devices: int = None,
    use_fused: bool = False,
    *,
    device=None,
    noise=None,
) -> dict:
    """Re-evaluate one run's placement/action plan under many sim seeds.

    ``plan`` is the ``plan_out`` dict of a ``run_experiment`` call.  The
    plan is replayed verbatim -- identical placements, migrations,
    evictions and resizes at identical times -- against ``len(sim_seeds)``
    independent telemetry streams in ONE ``state.batched_rollout`` call.
    Seed ``s`` draws what ``Cluster(seed=s)`` draws (``state.SeedNoise``),
    so the entry under the reference run's seed reproduces that run.

    ``bucket=True`` pads the plan to its power-of-two size class, as JAX
    does so that plans of one class share a compiled executable; the port
    compiles nothing, so here the padding only costs time and memory.  The
    padded windows lie past ``t_end`` and are masked out below.
    ``devices`` is JAX's shard request (clamped to the visible cards; see
    ``batched_rollout``); ``use_fused`` is JAX's ``use_pallas``: run the
    fused ``rollout_tick`` kernel tick.  ``device`` is where the replay
    runs (``None`` -> the CUDA card); ``noise`` optionally replaces the
    per-seed streams (one per seed, as ``batched_rollout`` takes them).

    Returns ``{"seeds": [...], "wall_s": float, "num_windows": int,
    "padded_windows": int}``; each per-seed entry carries avg/p90/p99 RT,
    arrival-phase cross-node cpu/mem util std (window-level) and the
    folded detector's hot-window count.  Warmup ticks (< 30) and padding
    past ``t_end`` are left out of the RT pool.  The RT series stays on the
    device: only each seed's positive samples in the valid ticks are
    copied to the host.  ``wall_s`` covers the rollout and that copy.
    """
    inp = replay_inputs(plan, window_ticks, bucket, device=device)
    dev = inp["state"].device
    num_nodes, span, t_end = inp["num_nodes"], inp["span"], inp["t_end"]
    padded_windows = inp["padded_windows"]
    streams = (list(noise) if noise is not None
               else [cstate.SeedNoise(s, num_nodes, dev) for s in sim_seeds])

    t0 = time.time()
    _, outs = cstate.batched_rollout(
        inp["state"], inp["profiles"], 0.0, streams, inp["events"],
        fleet=inp["fleet"], devices=devices, use_fused=use_fused)
    tick_idx = (np.arange(padded_windows)[:, None] * span
                + np.arange(span)[None, :])          # (W, span) global tick
    valid = (tick_idx >= 30) & (tick_idx < t_end)    # skip warmup + padding
    valid_t = torch.as_tensor(valid, device=dev)
    pools = []
    for i in range(len(streams)):
        r = outs["rt"][i][valid_t]                   # (ticks, N, S_ON)
        pools.append(r[r > 0].cpu().numpy())
    wall_s = time.time() - t0

    cpu = outs["cpu_util"].cpu().numpy()             # (B, W, N)
    mem = outs["mem_util"].cpu().numpy()
    hot = outs["hot"].cpu().numpy()
    w_start = np.arange(padded_windows) * span
    util_wins = ((w_start >= 30)
                 & (w_start + span <= t_end - inp["settle_ticks"]))
    if not util_wins.any():
        util_wins = np.ones(padded_windows, bool)    # degenerate short trace

    seeds_out = []
    for i, (s, samples) in enumerate(zip(sim_seeds, pools)):
        if samples.size == 0:
            samples = np.full(1, np.nan)
        seeds_out.append({
            "sim_seed": int(s),
            "avg_rt": float(samples.mean()),
            "p90_rt": float(np.percentile(samples, 90)),
            "p99_rt": float(np.percentile(samples, 99)),
            "cpu_util_std": float((100 * cpu[i][util_wins]).std(axis=1).mean()),
            "mem_util_std": float((100 * mem[i][util_wins]).std(axis=1).mean()),
            # padded windows simulate past t_end and could trip the
            # detector; only the real prefix counts
            "hot_windows": int(hot[i][:inp["num_windows"]].any(-1).sum()),
        })
    return {"seeds": seeds_out, "wall_s": wall_s,
            "num_windows": inp["num_windows"],
            "padded_windows": padded_windows}


def run_experiment_batched(
    scheduler,
    pods: list[Pod],
    gaps: list[int],
    num_nodes: int = 12,
    seed: int = 7,
    sim_seeds=tuple(range(20)),
    window_ticks: int = 40,
    **run_kwargs,
) -> tuple[ExperimentResult, dict]:
    """One reference ``run_experiment`` and a batched replay of its plan
    across ``sim_seeds`` on the same device.  Returns (reference_result,
    ``replay_plan_batched`` output)."""
    plan: dict = {}
    ref = run_experiment(scheduler, pods, gaps, num_nodes=num_nodes,
                         seed=seed, plan_out=plan, **run_kwargs)
    batch = replay_plan_batched(plan, sim_seeds=sim_seeds,
                                window_ticks=window_ticks,
                                device=run_kwargs.get("device"))
    return ref, batch


def compare_schedulers(
    num_pods: int = 60,
    num_nodes: int = 12,
    seed: int = 7,
    predictor=None,
    control: bool = False,
    control_config=None,
    proactive: bool = False,
    forecast: bool = False,
    trace: tuple | None = None,
    control_window: int | None = None,
    fleet=None,
    *,
    device=None,
    noise=None,
    plans_out: dict | None = None,
) -> dict[str, ExperimentResult]:
    """Figs. 13-15 comparison across ICO / RR / HUP / LQP (+ ICO-F).

    ``control=True`` pairs every scheduler with its own fresh
    ``ControlLoop`` (built per run from the shared predictor, so detector
    state, cooldowns and corrections never leak across schedulers), with
    the scheduler's tuned profile (``scheduler_loop_config``) unless
    ``control_config`` pins one; ``proactive=True`` switches the forecast
    channel on.  ``forecast=True`` adds ICO-F and threads a fresh
    ``ForecastService`` per run through the admission snapshots and (with
    proactive control) that run's loop, wherever something consumes it.
    ``trace`` optionally replaces the default arrival trace with a (pods,
    gaps) pair; ``control_window`` and ``fleet`` are forwarded to
    ``run_experiment``.  ``noise`` optionally gives each run its tick-noise
    stream: a zero-argument factory called once per run (every scheduler
    sees the same draws).  ``plans_out`` optionally receives each run's
    replayable plan under its scheduler's name.
    """
    from repro_torch.control import (
        ControlLoop,
        ForecastService,
        scheduler_loop_config,
    )

    device = resolve_device(device)
    predictor = predictor or train_default_predictor(seed=seed, device=device)
    pods, gaps = trace if trace is not None else _arrival_trace(num_pods, seed)
    out = {}
    for name, sched in make_schedulers(predictor, forecast=forecast).items():
        cfg = None
        if control:
            cfg = (control_config if control_config is not None
                   else scheduler_loop_config(name, proactive=proactive))
        svc = None
        # a service only where something reads it: ICO-F's admission, or a
        # proactive loop sharing the projection
        if forecast and (name == "ICO-F" or (control and proactive)):
            # the loop profile's gates and horizon: a shared service's own
            # config governs the projection inside the loop
            svc = (ForecastService(cfg.forecast, cfg.horizon, device=device)
                   if cfg is not None else ForecastService(device=device))
        loop = None
        if control:
            loop = lambda cfg=cfg, svc=svc: ControlLoop(  # noqa: E731
                InterferenceQuantifier(predictor.predict), cfg,
                forecast_service=svc)
        plan = plans_out.setdefault(name, {}) if plans_out is not None \
            else None
        out[name] = run_experiment(sched, pods, gaps, num_nodes=num_nodes,
                                   seed=seed, fleet=fleet, control_loop=loop,
                                   forecast=svc,
                                   control_window=control_window,
                                   device=device,
                                   noise=None if noise is None else noise(),
                                   plan_out=plan)
    return out
