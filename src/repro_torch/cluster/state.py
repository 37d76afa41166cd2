"""Cluster state, pure transforms and the simulator tick, on tensors.

Port of ``repro.cluster.state`` (the main-path part):

* ``ClusterState`` -- a frozen dataclass of the 12 per-node/per-slot
  tensors; ``FleetParams`` -- the four (N,) float32 delay-curve tensors.
* Pure transforms -- ``place_*`` / ``evict_*`` / ``migrate_*`` /
  ``resize_*`` / ``reconcile`` return a new state and never write the one
  they were given, as in the JAX package.
* ``_tick`` -- one 30 s tick: delay curve, Erlang(2) runqlat draws, the
  per-slot histograms (through ``metric.histograms``, i.e. one
  ``runqlat_hist`` kernel launch for both slot kinds on the card),
  response time and Table-III
  telemetry.  ``_window_core`` runs one tick per noise bundle and reduces
  them; ``rollout_chunks`` runs whole ``CHUNK``-tick chunks;
  ``merge_summaries`` is the host merge of the JAX package.
* Event replay -- ``extract_plan`` buckets the shell's mutation log into
  padded per-chunk event arrays (the JAX package's numpy arrays) and
  ``apply_events`` replays one chunk's events through the pure transforms.
* The batched replay engine -- ``scan_windows`` runs a whole plan window
  by window with the detector's node track and the forecaster's moments
  folded in; ``batched_rollout`` runs it under many seeds at once by
  folding the seed axis into the node axis (B seeds x N nodes = B*N rows).
  ``use_fused`` swaps the tick for ``_tick_fused``, whose delay curve,
  Erlang(2) draw and node histogram are one ``rollout_tick`` kernel launch.

Randomness has one seam, the ``TickNoise`` bundle: every draw ``_tick``
makes, as standard normals and uniforms in [tiny, 1).  By default the
bundles come from a ``torch.Generator`` on the device
(``draw_noise``, ``SeedNoise`` per simulation seed);
tests inject bundles that JAX drew from the same key, which makes the two
packages compute on the same inputs.

Inside a window the per-tick histograms and means are accumulated in place
rather than stacked: stacking 10 ticks of (N, 14, 200) would hold 112 MB at
1,000 nodes.  The counts are small integers, so the sums carry the same
bits in either order.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core import metric
from repro_torch.kernels import rollout_tick

S_ON = 8    # online slots per node
S_OFF = 6   # offline slots per node
SAMPLES_PER_TICK = 16
TICKS_PER_DAY = 2880.0

# contention model constants (the homogeneous defaults; per-node values
# live in FleetParams and reduce to these on a single-class fleet)
OS_BASE_CORES = 0.5
RUNQLAT_BASE = 3.0
RUNQLAT_SCALE = 55.0
RHO_EPS = 0.05
OVERSUB_SLOPE = 0.15
GAMMA_SHAPE = 2.0

CHUNK = 10  # ticks per chunk: the unit of rollout and of the noise stream

_TINY = float(np.finfo(np.float32).tiny)


def _season(t, phase):
    return 1.0 + 0.35 * torch.sin(2 * math.pi * t / TICKS_PER_DAY + phase) \
               + 0.12 * torch.sin(4 * math.pi * t / TICKS_PER_DAY + 1.7 * phase)


def delay_curve(rho, base=RUNQLAT_BASE, scale=RUNQLAT_SCALE, knee=RHO_EPS):
    """M/G/1-PS style delay vs run-queue pressure: convex, explodes near 1."""
    return base + scale * rho**2 / torch.maximum(1.0 - rho, torch.as_tensor(
        knee, dtype=rho.dtype, device=rho.device))


# --------------------------------------------------------------------------
# state and fleet
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ClusterState:
    """Per-node/per-slot cluster tensors (the JAX package's 12 arrays).

    ``*_active`` masks gate every term in the tick, so stale parameters in
    inactive slots are harmless; ``reconcile`` clears them for readers.
    """

    on_active: torch.Tensor      # (N, S_ON) bool
    on_type: torch.Tensor        # (N, S_ON) int32
    on_qps_mean: torch.Tensor    # (N, S_ON) float32
    on_phase: torch.Tensor       # (N, S_ON) float32
    off_active: torch.Tensor     # (N, S_OFF) bool
    off_cores: torch.Tensor      # (N, S_OFF) float32
    off_threads: torch.Tensor    # (N, S_OFF) float32
    off_mem: torch.Tensor        # (N, S_OFF) float32
    off_burst: torch.Tensor      # (N, S_OFF) float32
    off_remaining: torch.Tensor  # (N, S_OFF) int32
    cpu_sum: torch.Tensor        # (N,) float32
    mem_sum: torch.Tensor        # (N,) float32

    @classmethod
    def create(cls, num_nodes: int, cores=32.0, mem_gb=64.0, *,
               device) -> "ClusterState":
        """``cores``/``mem_gb`` are scalars or (N,) per-node capacities."""
        def z(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=device)

        def cap(v):
            return torch.as_tensor(np.broadcast_to(
                np.asarray(v, np.float32), (num_nodes,)).copy(),
                device=device)

        return cls(
            on_active=z((num_nodes, S_ON), torch.bool),
            on_type=z((num_nodes, S_ON), torch.int32),
            on_qps_mean=z((num_nodes, S_ON), torch.float32),
            on_phase=z((num_nodes, S_ON), torch.float32),
            off_active=z((num_nodes, S_OFF), torch.bool),
            off_cores=z((num_nodes, S_OFF), torch.float32),
            off_threads=z((num_nodes, S_OFF), torch.float32),
            off_mem=z((num_nodes, S_OFF), torch.float32),
            off_burst=torch.ones((num_nodes, S_OFF), dtype=torch.float32,
                                 device=device),
            off_remaining=z((num_nodes, S_OFF), torch.int32),
            cpu_sum=cap(cores),
            mem_sum=cap(mem_gb),
        )

    @property
    def num_nodes(self) -> int:
        return self.cpu_sum.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.cpu_sum.device

    def replace(self, **kw) -> "ClusterState":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class FleetParams:
    """Per-node delay-curve parameters: what the hardware is, which no
    transform writes.  ``uniform(n)`` is the homogeneous fleet."""

    delay_base: torch.Tensor     # (N,) float32
    delay_scale: torch.Tensor    # (N,) float32
    rho_knee: torch.Tensor       # (N,) float32
    oversub_slope: torch.Tensor  # (N,) float32

    @classmethod
    def uniform(cls, num_nodes: int, *, device) -> "FleetParams":
        def full(v):
            return torch.full((num_nodes,), v, dtype=torch.float32,
                              device=device)

        return cls(delay_base=full(RUNQLAT_BASE),
                   delay_scale=full(RUNQLAT_SCALE),
                   rho_knee=full(RHO_EPS),
                   oversub_slope=full(OVERSUB_SLOPE))

    @property
    def num_nodes(self) -> int:
        return self.delay_base.shape[-1]


# --------------------------------------------------------------------------
# pure transforms (each returns a new state; the argument is not written)
# --------------------------------------------------------------------------


def _set(a: torch.Tensor, idx, value) -> torch.Tensor:
    out = a.clone()
    out[idx] = value
    return out


def _move(a: torch.Tensor, src, dst, fill) -> torch.Tensor:
    out = a.clone()
    out[dst] = a[src]
    out[src] = fill
    return out


def place_online(state: ClusterState, node, slot, type_id, qps,
                 phase) -> ClusterState:
    idx = (node, slot)
    return state.replace(
        on_active=_set(state.on_active, idx, True),
        on_type=_set(state.on_type, idx, int(type_id)),
        on_qps_mean=_set(state.on_qps_mean, idx, qps),
        on_phase=_set(state.on_phase, idx, phase),
    )


def place_offline(state: ClusterState, node, slot, cores, threads, mem,
                  burst, remaining) -> ClusterState:
    idx = (node, slot)
    return state.replace(
        off_active=_set(state.off_active, idx, True),
        off_cores=_set(state.off_cores, idx, cores),
        off_threads=_set(state.off_threads, idx, threads),
        off_mem=_set(state.off_mem, idx, mem),
        off_burst=_set(state.off_burst, idx, burst),
        off_remaining=_set(state.off_remaining, idx, int(remaining)),
    )


def evict_online(state: ClusterState, node, slot) -> ClusterState:
    # clears the slot params too, so readers between a remove and the next
    # reconcile never see the departed pod's allocation
    idx = (node, slot)
    return state.replace(
        on_active=_set(state.on_active, idx, False),
        on_type=_set(state.on_type, idx, 0),
        on_qps_mean=_set(state.on_qps_mean, idx, 0.0),
        on_phase=_set(state.on_phase, idx, 0.0),
    )


def evict_offline(state: ClusterState, node, slot) -> ClusterState:
    idx = (node, slot)
    return state.replace(
        off_active=_set(state.off_active, idx, False),
        off_cores=_set(state.off_cores, idx, 0.0),
        off_threads=_set(state.off_threads, idx, 0.0),
        off_mem=_set(state.off_mem, idx, 0.0),
        off_burst=_set(state.off_burst, idx, 1.0),
        off_remaining=_set(state.off_remaining, idx, 0),
    )


def migrate_online(state: ClusterState, src, src_slot, dst,
                   dst_slot) -> ClusterState:
    si, di = (src, src_slot), (dst, dst_slot)
    active = _set(state.on_active, di, True)
    active[si] = False
    return state.replace(
        on_active=active,
        on_type=_move(state.on_type, si, di, 0),
        on_qps_mean=_move(state.on_qps_mean, si, di, 0.0),
        on_phase=_move(state.on_phase, si, di, 0.0),
    )


def migrate_offline(state: ClusterState, src, src_slot, dst,
                    dst_slot) -> ClusterState:
    si, di = (src, src_slot), (dst, dst_slot)
    active = _set(state.off_active, di, True)
    active[si] = False
    return state.replace(
        off_active=active,
        off_cores=_move(state.off_cores, si, di, 0.0),
        off_threads=_move(state.off_threads, si, di, 0.0),
        off_mem=_move(state.off_mem, si, di, 0.0),
        off_burst=_move(state.off_burst, si, di, 1.0),
        off_remaining=_move(state.off_remaining, si, di, 0),
    )


def resize_online(state: ClusterState, node, slot, qps) -> ClusterState:
    return state.replace(
        on_qps_mean=_set(state.on_qps_mean, (node, slot), qps))


def resize_offline(state: ClusterState, node, slot, cores, threads, mem,
                   remaining) -> ClusterState:
    """Set an offline slot's post-resize values (absolute targets)."""
    idx = (node, slot)
    return state.replace(
        off_cores=_set(state.off_cores, idx, cores),
        off_threads=_set(state.off_threads, idx, threads),
        off_mem=_set(state.off_mem, idx, mem),
        off_remaining=_set(state.off_remaining, idx, int(remaining)),
    )


def reconcile(state: ClusterState):
    """Clear finished offline slots (deactivated by the tick but still
    carrying parameters).  Returns (new_state, stale_mask)."""
    stale = (~state.off_active) & (state.off_cores > 0.0)

    def clr(a, fill):
        return torch.where(stale, torch.as_tensor(fill, dtype=a.dtype,
                                                  device=a.device), a)

    cleared = state.replace(
        off_cores=clr(state.off_cores, 0.0),
        off_threads=clr(state.off_threads, 0.0),
        off_mem=clr(state.off_mem, 0.0),
        off_burst=clr(state.off_burst, 1.0),
        off_remaining=clr(state.off_remaining, 0),
    )
    return cleared, stale


# --------------------------------------------------------------------------
# the noise seam
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TickNoise:
    """Every random draw one ``_tick`` makes (JAX ``state.py`` l.501-603)."""

    qps: torch.Tensor      # (N, S_ON) standard normal
    delay: torch.Tensor    # (N,) standard normal
    jit_on: torch.Tensor   # (N, S_ON) standard normal
    jit_off: torch.Tensor  # (N, S_OFF) standard normal
    u_on: torch.Tensor     # (N, S_ON, SAMPLES_PER_TICK, 2) uniform [tiny, 1)
    u_off: torch.Tensor    # (N, S_OFF, SAMPLES_PER_TICK, 2) uniform [tiny, 1)
    rt: torch.Tensor       # (N, S_ON) standard normal
    hw: torch.Tensor       # (N, 8) standard normal


_NORMAL_COLS = (("qps", S_ON), ("delay", 1), ("jit_on", S_ON),
                ("jit_off", S_OFF), ("rt", S_ON), ("hw", 8))
_NUM_NORMALS = sum(c for _, c in _NORMAL_COLS)
_NUM_UNIFORMS = (S_ON + S_OFF) * SAMPLES_PER_TICK * 2


def _draw_raw(generator: torch.Generator, num_nodes: int, num_ticks: int):
    """The two bulk draws behind ``num_ticks`` bundles: (T, N, normals)
    and (T, N, uniforms), on the generator's device."""
    device = generator.device
    z = torch.randn((num_ticks, num_nodes, _NUM_NORMALS),
                    generator=generator, device=device)
    u = torch.rand((num_ticks, num_nodes, _NUM_UNIFORMS),
                   generator=generator, device=device).clamp_min_(_TINY)
    return z, u


def _bundles(z: torch.Tensor, u: torch.Tensor) -> list[TickNoise]:
    """Split bulk draws into one ``TickNoise`` of views per tick."""
    num_nodes = z.shape[1]
    split = S_ON * SAMPLES_PER_TICK * 2
    out = []
    for i in range(z.shape[0]):
        cols, c0 = {}, 0
        for name, width in _NORMAL_COLS:
            cols[name] = z[i, :, c0:c0 + width]
            c0 += width
        cols["delay"] = cols["delay"][:, 0]
        out.append(TickNoise(
            u_on=u[i, :, :split].reshape(num_nodes, S_ON, SAMPLES_PER_TICK, 2),
            u_off=u[i, :, split:].reshape(num_nodes, S_OFF,
                                          SAMPLES_PER_TICK, 2),
            **cols))
    return out


def draw_noise(generator: torch.Generator, num_nodes: int,
               num_ticks: int) -> list[TickNoise]:
    """``num_ticks`` bundles from two bulk draws on the generator's device."""
    return _bundles(*_draw_raw(generator, num_nodes, num_ticks))


class SeedNoise:
    """One simulation seed's endless per-chunk noise stream: each item is
    ``CHUNK`` tick bundles.

    A ``torch.Generator`` on ``device`` seeded with ``seed`` and one
    ``draw_noise(generator, num_nodes, CHUNK)`` per chunk.  The counterpart
    of JAX ``chunk_key_stream``: ``Cluster(seed=seed)`` draws from it, and
    so does a replay under that seed, which therefore reproduces the run.
    ``draw`` hands out a chunk's raw draws, which lets ``batched_noise``
    concatenate many seeds once per chunk.
    """

    def __init__(self, seed: int, num_nodes: int, device):
        self.generator = torch.Generator(device=device)
        self.generator.manual_seed(int(seed))
        self.num_nodes = num_nodes

    def draw(self):
        return _draw_raw(self.generator, self.num_nodes, CHUNK)

    def __iter__(self):
        return self

    def __next__(self) -> list[TickNoise]:
        return _bundles(*self.draw())


def batched_noise(streams):
    """Merge B per-seed chunk streams into one over B*N rows: row
    ``n + b*N`` of every bundle is node ``n`` of seed ``b``.

    ``SeedNoise`` streams are concatenated as raw draws, two
    concatenations per chunk; any other streams (for example JAX's draws
    injected by the tests) field by field.
    """
    if all(isinstance(s, SeedNoise) for s in streams):
        while True:
            raw = [s.draw() for s in streams]
            yield _bundles(torch.cat([z for z, _ in raw], dim=1),
                           torch.cat([u for _, u in raw], dim=1))
    its = [iter(s) for s in streams]
    names = [f.name for f in dataclasses.fields(TickNoise)]
    while True:
        chunks = [next(it) for it in its]
        yield [TickNoise(**{k: torch.cat([getattr(c[i], k) for c in chunks])
                            for k in names})
               for i in range(len(chunks[0]))]


# --------------------------------------------------------------------------
# the tick
# --------------------------------------------------------------------------


def _load(st: ClusterState, profiles, t, noise: TickNoise) -> dict:
    """The tick's load model, shared by ``_tick`` and ``_tick_fused``: QPS
    with seasonality and noise, per-slot CPU / thread / memory demand, the
    node's run-queue pressure and utilization."""
    on_active = st.on_active
    on_type = st.on_type
    qps_noise = 1.0 + 0.06 * noise.qps
    qps_t = st.on_qps_mean * _season(t, st.on_phase) * qps_noise
    qps_t = torch.where(on_active, torch.clamp_min(qps_t, 0.0), 0.0)

    cpu_on = torch.where(
        on_active,
        profiles["cpu_per_qps"][on_type] * qps_t + profiles["cpu_base"][on_type],
        0.0)
    thr_on = torch.where(on_active,
                         profiles["threads_per_qps"][on_type] * qps_t, 0.0)
    mem_on = torch.where(
        on_active,
        profiles["mem_per_qps"][on_type] * qps_t + profiles["mem_base"][on_type],
        0.0)

    off_active = st.off_active
    cpu_off = torch.where(off_active, st.off_cores, 0.0)
    thr_off = torch.where(off_active, st.off_threads, 0.0)
    mem_off = torch.where(off_active, st.off_mem, 0.0)
    burst_off = torch.where(off_active, st.off_burst, 0.0)

    cores = st.cpu_sum
    # measured CPU demand uses average usage; run-queue pressure uses peak
    # (bursty) usage -- the information loss the paper's metric exploits
    cpu_on_sum = cpu_on.sum(-1)
    total_cpu = cpu_on_sum + cpu_off.sum(-1) + OS_BASE_CORES
    pressure_cpu = cpu_on_sum + (cpu_off * burst_off).sum(-1) + OS_BASE_CORES
    mem_used = mem_on.sum(-1) + mem_off.sum(-1) + 2.0
    return {
        "qps": qps_t,
        "cpu_off": cpu_off,
        "mem_off": mem_off,
        "total_cpu": total_cpu,
        "rho_p": pressure_cpu / cores,
        "threads_total": thr_on.sum(-1) + thr_off.sum(-1) + 2.0,
        "mem_used": mem_used,
        "cpu_util": torch.minimum(total_cpu, cores) / cores,
        "mem_util": torch.minimum(mem_used, st.mem_sum) / st.mem_sum,
    }


def _online_rt(st: ClusterState, profiles, qps_t, mean_on, mem_used,
               noise: TickNoise):
    """Online response time: service + queueing delay (the slots' mean
    runqlat ``mean_on``) + cache contention.  Returns (rt, mem_press)."""
    on_type = st.on_type
    base_rt = profiles["base_rt"][on_type]
    sat = torch.clamp_min(qps_t / profiles["qps_cap"][on_type] - 0.8, 0.0)
    mem_press = torch.clamp_max(mem_used / st.mem_sum, 1.2)
    cache_term = 0.06 * base_rt * mem_press[:, None]
    rt = base_rt * (1.0 + 1.5 * sat) \
        + profiles["rt_per_runqlat"][on_type] * mean_on \
        + cache_term \
        + 0.06 * base_rt * noise.rt
    return torch.where(st.on_active, torch.clamp_min(rt, 0.5), 0.0), mem_press


def _age(st: ClusterState) -> ClusterState:
    """Age offline jobs by one tick; a job whose time runs out stops."""
    new_rem = torch.where(st.off_active, st.off_remaining - 1,
                          st.off_remaining)
    return st.replace(off_remaining=new_rem,
                      off_active=st.off_active & (new_rem > 0))


def _tick(st: ClusterState, profiles, fleet: FleetParams, t,
          noise: TickNoise | None = None,
          generator: torch.Generator | None = None):
    """One tick.  ``t`` is a 0-d float32 tensor; ``noise`` defaults to a
    bundle drawn from ``generator``.  Returns (new_state, outputs)."""
    if noise is None:
        noise = draw_noise(generator, st.num_nodes, 1)[0]

    ld = _load(st, profiles, t, noise)
    qps_t, total_cpu, mem_used = ld["qps"], ld["total_cpu"], ld["mem_used"]
    threads_total = ld["threads_total"]
    cores = st.cpu_sum
    rho = total_cpu / cores

    delay = delay_curve(ld["rho_p"], base=fleet.delay_base,
                        scale=fleet.delay_scale, knee=fleet.rho_knee)
    delay = delay * (1.0 + fleet.oversub_slope
                     * torch.clamp_min(threads_total / cores - 1.0, 0.0))
    delay = delay * torch.exp(0.13 * noise.delay)
    delay = torch.clamp(delay, 0.0, 2.5 * metric.OVERFLOW_EDGE)

    def pod_samples(jit_noise, u, active):
        # Erlang(2) == Gamma(2): -log(U1*U2), mean == node delay x jitter
        jit_ = 1.0 + 0.18 * jit_noise
        mean = delay[:, None] * torch.clamp_min(jit_, 0.3)
        g = -torch.log(u[..., 0] * u[..., 1])
        samples = g * (mean[..., None] / GAMMA_SHAPE)
        # the slot's 0/1 weight, broadcast along its samples (stride 0)
        w = active.float()[..., None].expand(samples.shape)
        return samples, w, mean

    on_active, off_active = st.on_active, st.off_active
    s_on, w_on, mean_on = pod_samples(noise.jit_on, noise.u_on, on_active)
    s_off, w_off, _ = pod_samples(noise.jit_off, noise.u_off, off_active)
    # (N, S_ON, 200) and (N, S_OFF, 200): one kernel launch for both
    hist_on, hist_off = metric.histograms((s_on, w_on), (s_off, w_off))

    n_pods = on_active.sum(-1) + off_active.sum(-1)
    rt, mem_press = _online_rt(st, profiles, qps_t, mean_on, mem_used, noise)

    # hardware events (Table III), load-dependent with noise
    hw_noise = 1.0 + 0.05 * noise.hw
    used = torch.minimum(total_cpu, cores)
    instructions = used * 2.4e9
    cache_pressure = mem_press + 0.04 * n_pods
    ipc = torch.clamp_min(2.2 - 0.7 * torch.clamp_max(rho, 1.3)
                          - 0.3 * cache_pressure, 0.4)
    cycles = instructions / ipc
    cache_refs = instructions * 0.30
    cache_misses = cache_refs * (0.02 + 0.08 * cache_pressure)
    branch_ins = instructions * 0.18
    branch_miss = branch_ins * (0.01 + 0.02 * torch.clamp_max(rho, 1.5))
    ctx_sw = threads_total * 120.0 * (1.0 + torch.clamp_min(rho - 0.7, 0.0)
                                      * 3.0)
    migrations = ctx_sw * 0.02
    hw = torch.stack(
        [cycles, instructions, cache_refs, cache_misses,
         branch_ins, branch_miss, ctx_sw, migrations], dim=-1) * hw_noise

    # perf metrics (12 cols, Table III order)
    qps_node = qps_t.sum(-1)
    off_cpu_sum = ld["cpu_off"].sum(-1)
    perf = torch.stack([
        ld["cpu_util"],
        ld["mem_util"],
        0.25 * mem_used,             # mem_cache
        1500.0 * total_cpu,          # mem_pgfault
        3.0 * ld["mem_off"].sum(-1),  # mem_pgmajfault
        0.8 * mem_used,              # working_set
        0.7 * mem_used,              # memory_rss
        0.002 * qps_node,            # net_recv_avg (MB/s)
        1.2 * qps_node,              # net_recv_packets_avg
        0.008 * qps_node,            # net_send_avg
        1.1 * qps_node,              # net_send_packets_avg
        0.5 * off_cpu_sum,           # disk_io_avg
    ], dim=-1)

    out = {
        "hist_on": hist_on,
        "hist_off": hist_off,
        "rt": rt,
        "qps": qps_t,
        "cpu_util": ld["cpu_util"],
        "mem_util": ld["mem_util"],
        "mem_used": mem_used,
        "cpu_demand": total_cpu,
        "hw": hw,
        "perf": perf,
        "delay": delay,
        "mean_on": mean_on,
    }
    return _age(st), out


_SUM_KEYS = ("hist_on", "hist_off")
_MEAN_KEYS = ("qps", "cpu_util", "mem_util", "mem_used", "cpu_demand", "hw",
              "perf", "delay", "mean_on")


def _window_core(state: ClusterState, profiles, fleet, t0: float,
                 noise: list[TickNoise]):
    """Run one tick per bundle of ``noise`` from time ``t0``.

    Returns (new_state, summary): histograms summed over the ticks, RT and
    utilization series stacked (W, ...), everything else the tick mean.
    """
    num_ticks = len(noise)
    ts = torch.arange(num_ticks, dtype=torch.float32,
                      device=state.device) + t0
    acc: dict[str, torch.Tensor] = {}
    rt, cpu_s, mem_s = [], [], []
    for i in range(num_ticks):
        state, out = _tick(state, profiles, fleet, ts[i], noise[i])
        for k in _SUM_KEYS + _MEAN_KEYS:
            if k in acc:
                acc[k].add_(out[k])
            else:  # a fresh copy: some outputs also go into the series
                acc[k] = out[k].clone()
        rt.append(out["rt"])
        cpu_s.append(out["cpu_util"])
        mem_s.append(out["mem_util"])
    summary = {k: acc[k] for k in _SUM_KEYS}
    summary["rt"] = torch.stack(rt)                 # (W, N, S_ON)
    for k in _MEAN_KEYS:
        summary[k] = acc[k] / num_ticks
    summary["cpu_util_series"] = torch.stack(cpu_s)  # (W, N)
    summary["mem_util_series"] = torch.stack(mem_s)
    return state, summary


def rollout_chunks(state: ClusterState, profiles, fleet, t0: float,
                   num_chunks: int, noise_stream):
    """Run ``num_chunks`` CHUNK-tick windows, taking one item of
    ``noise_stream`` per chunk.  Returns (final_state, per-chunk summaries);
    ``merge_summaries`` reduces them as the JAX host merge does."""
    parts = []
    for c in range(num_chunks):
        state, summary = _window_core(state, profiles, fleet,
                                      t0 + c * CHUNK, next(noise_stream))
        parts.append(summary)
    return state, parts


def merge_summaries(parts: list[dict]):
    """Histograms sum, series concatenate, everything else is the mean of
    the per-chunk means (the JAX package's order of additions)."""
    if len(parts) == 1:
        return parts[0]
    merged = {}
    for k in parts[0]:
        vals = [p[k] for p in parts]
        if k in _SUM_KEYS:
            merged[k] = sum(vals[1:], vals[0])
        elif k in ("rt", "cpu_util_series", "mem_util_series"):
            merged[k] = torch.cat(vals, dim=0)
        else:
            merged[k] = sum(vals[1:], vals[0]) / len(vals)
    return merged


# --------------------------------------------------------------------------
# event replay: op-coded mutations applied between chunks
# --------------------------------------------------------------------------

EV_PLACE_ON, EV_PLACE_OFF, EV_EVICT_ON, EV_EVICT_OFF, EV_MIGRATE_ON, \
    EV_MIGRATE_OFF, EV_RESIZE_ON, EV_RESIZE_OFF, EV_NOOP = range(9)

_OP_CODES = {
    "place_on": EV_PLACE_ON,
    "place_off": EV_PLACE_OFF,
    "evict_on": EV_EVICT_ON,
    "evict_off": EV_EVICT_OFF,
    "migrate_on": EV_MIGRATE_ON,
    "migrate_off": EV_MIGRATE_OFF,
    "resize_on": EV_RESIZE_ON,
    "resize_off": EV_RESIZE_OFF,
}


def _apply_event(state: ClusterState, op: int, n, s: int, d, ds: int,
                 f: np.ndarray) -> ClusterState:
    if op == EV_PLACE_ON:
        return place_online(state, n, s, int(f[0]), float(f[1]), float(f[2]))
    if op == EV_PLACE_OFF:
        return place_offline(state, n, s, float(f[0]), float(f[1]),
                             float(f[2]), float(f[3]), int(f[4]))
    if op == EV_EVICT_ON:
        return evict_online(state, n, s)
    if op == EV_EVICT_OFF:
        return evict_offline(state, n, s)
    if op == EV_MIGRATE_ON:
        return migrate_online(state, n, s, d, ds)
    if op == EV_MIGRATE_OFF:
        return migrate_offline(state, n, s, d, ds)
    if op == EV_RESIZE_ON:
        return resize_online(state, n, s, float(f[0]))
    if op == EV_RESIZE_OFF:
        return resize_offline(state, n, s, float(f[0]), float(f[1]),
                              float(f[2]), int(f[4]))
    raise ValueError(f"unknown event op code {op}")


def apply_events(state: ClusterState, events: dict,
                 batch: int = 1) -> ClusterState:
    """Apply one chunk's padded event list (numpy leaves shaped (E, ...))
    in order, skipping ``EV_NOOP`` padding.

    The plan is host data shared by every seed, so the events are walked on
    the host and applied through the pure transforms.  With ``batch`` B the
    state holds B seeds of N = R / B node rows each, and an event on node
    ``n`` applies to rows ``n + b*N`` for every seed ``b``.
    """
    ops = events["op"]
    live = np.flatnonzero(ops != EV_NOOP)
    if live.size == 0:
        return state
    offsets = None
    if batch > 1:
        offsets = torch.arange(batch, device=state.device) * (
            state.num_nodes // batch)

    def rows(node):
        return int(node) if offsets is None else offsets + int(node)

    for e in live:
        state = _apply_event(state, int(ops[e]), rows(events["node"][e]),
                             int(events["slot"][e]), rows(events["dst"][e]),
                             int(events["dslot"][e]), events["f"][e])
    return state


def _next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (int(n) - 1).bit_length()


def extract_plan(log, t0: float, num_windows: int,
                 chunks_per_window: int, bucket: bool = False) -> dict:
    """Bucket a ``Cluster`` mutation log into padded per-chunk event arrays.

    ``log`` entries are the shell's host tuples ``(op, t, node, slot,
    *params)`` (``(op, t, src, ss, dst, ds)`` for migrations).  An event
    logged at time ``t`` applies before the chunk covering ``t``.  Returns
    numpy ``{"op", "node", "slot", "dst", "dslot", "f"}`` with leading
    shape (num_windows, chunks_per_window, E_max), the JAX package's
    arrays.  ``bucket=True`` rounds E_max and the window count up to powers
    of two, padding with NOOP events and event-free windows; the padded
    windows lie past the plan's span, so the real prefix is unchanged.
    """
    buckets: list[list] = [[] for _ in range(num_windows * chunks_per_window)]
    for entry in log:
        c = int((entry[1] - t0) // CHUNK)
        if c < 0 or c >= len(buckets):
            raise ValueError(
                f"log entry at t={entry[1]} outside the planned span "
                f"[{t0}, {t0 + len(buckets) * CHUNK})")
        buckets[c].append(entry)
    emax = max(1, max((len(b) for b in buckets), default=1))
    if bucket:
        emax = _next_pow2(emax)
        num_windows = _next_pow2(num_windows)
    shape = (num_windows, chunks_per_window, emax)
    plan = {
        "op": np.full(shape, EV_NOOP, np.int32),
        "node": np.zeros(shape, np.int32),
        "slot": np.zeros(shape, np.int32),
        "dst": np.zeros(shape, np.int32),
        "dslot": np.zeros(shape, np.int32),
        "f": np.zeros(shape + (5,), np.float32),
    }
    for c, evs in enumerate(buckets):
        w, cw = divmod(c, chunks_per_window)
        for e, entry in enumerate(evs):
            kind = entry[0]
            plan["op"][w, cw, e] = _OP_CODES[kind]
            plan["node"][w, cw, e] = entry[2]
            plan["slot"][w, cw, e] = entry[3]
            if kind in ("migrate_on", "migrate_off"):
                plan["dst"][w, cw, e] = entry[4]
                plan["dslot"][w, cw, e] = entry[5]
            else:
                vals = entry[4:]
                plan["f"][w, cw, e, :len(vals)] = vals
    return plan


# --------------------------------------------------------------------------
# the fused-kernel tick (lite outputs only)
# --------------------------------------------------------------------------


def _tick_fused(st: ClusterState, profiles, fleet: FleetParams, t,
                noise: TickNoise):
    """``_tick`` with the delay curve, the Erlang(2) draw and the node
    histogram in one ``rollout_tick`` kernel launch (JAX ``_tick_pallas``).

    It reads the same ``TickNoise`` bundle and the same load and RT model
    as ``_tick``, so the two paths compute on the same draws.  Only the
    lite outputs the window scan reads are produced: RT, QPS, CPU and
    memory utilization, node histogram.  The kernel reads the fields, the
    masks and the noise bundle where they lie: nothing is packed for it.
    """
    ld = _load(st, profiles, t, noise)
    node_hist, _delay, mean_all = rollout_tick.fused_tick_unpacked(
        (ld["rho_p"], ld["threads_total"], st.cpu_sum, fleet.delay_base,
         fleet.delay_scale, fleet.rho_knee, fleet.oversub_slope, noise.delay),
        noise.jit_on, noise.jit_off, st.on_active, st.off_active, noise.u_on,
        noise.u_off, gamma_shape=GAMMA_SHAPE,
        clip_max=2.5 * metric.OVERFLOW_EDGE)
    rt, _ = _online_rt(st, profiles, ld["qps"], mean_all[:, :S_ON],
                       ld["mem_used"], noise)
    return _age(st), {"rt": rt, "qps": ld["qps"], "cpu_util": ld["cpu_util"],
                      "mem_util": ld["mem_util"], "node_hist": node_hist}


_LITE_MEANS = ("qps", "cpu_util", "mem_util")


def _window_lite(state: ClusterState, profiles, fleet, t0: float,
                 noise: list[TickNoise], rt_out: torch.Tensor, *,
                 use_fused: bool = False):
    """One chunk of the window scan, reduced to the lite dict it reads.

    ``use_fused`` runs ``_tick_fused`` (JAX ``_window_lite_pallas``);
    otherwise ``_window_core`` runs the default ``_tick`` and its per-slot
    histograms are summed per node.  The (T, R, S_ON) RT series is written
    into ``rt_out`` (a view of the caller's output), not stacked.  Returns
    (new_state, lite) with the tick means of qps / cpu_util / mem_util and
    the summed node histogram.  Histogram bins hold small integer counts,
    so both paths sum to the same bits.
    """
    if not use_fused:
        state, s = _window_core(state, profiles, fleet, t0, noise)
        rt_out.copy_(s["rt"])
        return state, {
            "qps": s["qps"], "cpu_util": s["cpu_util"],
            "mem_util": s["mem_util"],
            "node_hist": s["hist_on"].sum(1) + s["hist_off"].sum(1),
        }
    num_ticks = len(noise)
    ts = torch.arange(num_ticks, dtype=torch.float32,
                      device=state.device) + t0
    acc: dict[str, torch.Tensor] = {}
    for i in range(num_ticks):
        state, out = _tick_fused(state, profiles, fleet, ts[i], noise[i])
        rt_out[i].copy_(out["rt"])
        for k in _LITE_MEANS + ("node_hist",):
            if k in acc:
                acc[k].add_(out[k])
            else:  # the tick's own tensor: nothing else reads it
                acc[k] = out[k]
    lite = {k: acc[k] / num_ticks for k in _LITE_MEANS}
    lite["node_hist"] = acc["node_hist"]
    return state, lite


# --------------------------------------------------------------------------
# the window scan with the detector and forecaster folded in
# --------------------------------------------------------------------------


def fold_configs(det_cfg=None, fc_cfg=None) -> tuple[dict, dict]:
    """Scalar bundles for the folded detector node track and forecaster
    moment update (defaults are ``DetectorConfig`` / ``ForecastConfig``)."""
    # the control package imports the cluster modules: import it here
    from repro_torch.control.detector import DetectorConfig
    from repro_torch.control.forecast import ForecastConfig

    d = det_cfg or DetectorConfig()
    f = fc_cfg or ForecastConfig()
    det = dict(decay=d.decay, alpha=d.baseline_alpha, slack=d.slack,
               drift_thr=d.drift_threshold, q=d.quantile,
               abs_thr=d.abs_threshold, warmup=d.warmup)
    fc = dict(decay=f.decay, ridge=f.ridge, alpha=f.err_alpha,
              qps_floor=f.qps_floor)
    return det, fc


def init_fold_state(num_nodes: int, *, device):
    """Zeroed carry for the folded detector node track and forecaster
    moments: (det hist, det mu, det cusum, det steps, fc A, fc b, fc err,
    fc count).  ``steps`` is a host integer shared by every row."""
    from repro_torch.control.forecast import NUM_FEATURES

    def z(shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return (z((num_nodes, metric.NUM_BINS)), z((num_nodes,)), z((num_nodes,)),
            0,
            z((num_nodes, S_ON, NUM_FEATURES, NUM_FEATURES)),
            z((num_nodes, S_ON, NUM_FEATURES)), z((num_nodes, S_ON)),
            z((num_nodes, S_ON), torch.int32))


def scan_windows(state: ClusterState, profiles, fleet, t0: float, noise,
                 events: dict, det: dict, fc: dict, fold0, *,
                 use_fused: bool = False, batch: int = 1):
    """One experiment timeline: per window, for each of its chunks apply
    that chunk's events and roll CHUNK ticks; then fold the window's node
    histograms into the detector's CUSUM track and its mean QPS into the
    forecaster's harmonic moments.

    ``noise`` yields one list of CHUNK ``TickNoise`` bundles per chunk
    (rows as the state's); ``events`` leaves are (W, C, E, ...) numpy.
    ``use_fused`` (JAX's ``use_pallas``) runs the fused ``rollout_tick``
    kernel tick instead of the default ``_tick``.  ``batch`` says how many
    seeds the R state rows hold (see ``apply_events``).

    Returns (final, outs): ``final`` holds the state, the end time and the
    fold carry; ``outs`` holds the RT series (W, C*CHUNK, R, S_ON),
    window-mean qps (W, R, S_ON), cpu/mem util (W, R) and the detector's
    hotspot flags (W, R).
    """
    from repro_torch.control.detector import node_track_step
    from repro_torch.control.forecast import _forecast_update

    num_windows, cpw = events["op"].shape[:2]
    rows, device = state.num_nodes, state.device
    dh, dmu, dcu, dsteps, A, b, err, cnt = fold0
    outs = {
        "rt": torch.empty((num_windows, cpw * CHUNK, rows, S_ON),
                          dtype=torch.float32, device=device),
        "qps": torch.empty((num_windows, rows, S_ON), dtype=torch.float32,
                           device=device),
        "cpu_util": torch.empty((num_windows, rows), dtype=torch.float32,
                                device=device),
        "mem_util": torch.empty((num_windows, rows), dtype=torch.float32,
                                device=device),
        "hot": torch.empty((num_windows, rows), dtype=torch.bool,
                           device=device),
    }
    t = float(t0)
    for w in range(num_windows):
        acc: dict[str, torch.Tensor] = {}
        for c in range(cpw):
            state = apply_events(state, {k: v[w, c] for k, v in events.items()},
                                 batch)
            state, lite = _window_lite(
                state, profiles, fleet, t, next(noise),
                outs["rt"][w, c * CHUNK:(c + 1) * CHUNK], use_fused=use_fused)
            t += CHUNK
            for k in _LITE_MEANS + ("node_hist",):
                if k in acc:
                    acc[k].add_(lite[k])
                else:  # a fresh tensor of this chunk's reduction
                    acc[k] = lite[k]
        qps = acc["qps"] / cpw
        dh, _avg, _pt, dmu, dcu, _trip, _dt, _at, _raw, hot = node_track_step(
            dh, dmu, dcu, dsteps, acc["node_hist"], det["decay"], det["alpha"],
            det["slack"], det["drift_thr"], det["q"], det["abs_thr"],
            det["warmup"])
        dsteps += 1
        A, b, err, cnt, _pred = _forecast_update(
            A, b, err, cnt, torch.full((), t, dtype=torch.float32,
                                       device=device),
            qps, state.on_active, fc["decay"], fc["ridge"], fc["alpha"],
            fc["qps_floor"])
        outs["qps"][w] = qps
        outs["cpu_util"][w] = acc["cpu_util"] / cpw
        outs["mem_util"][w] = acc["mem_util"] / cpw
        outs["hot"][w] = hot
    final = {"state": state, "t": t, "det_hist": dh, "det_mu": dmu,
             "det_cusum": dcu, "det_steps": dsteps, "fc_A": A, "fc_b": b,
             "fc_err": err, "fc_count": cnt}
    return final, outs


def _check_shards(devices, device: torch.device) -> None:
    """Clamp JAX's ``devices`` shard request to the cards visible from
    ``device`` and refuse a request that would really shard."""
    if devices is None or devices <= 1:
        return
    visible = torch.cuda.device_count() if device.type == "cuda" else 1
    if min(devices, visible) > 1:
        raise NotImplementedError(
            f"devices={devices} would shard the seeds across "
            f"{min(devices, visible)} cards; seed sharding is not ported, "
            "pass devices=None for the single-card result")


def _tile(x: torch.Tensor, batch: int) -> torch.Tensor:
    return x.repeat(batch, *([1] * (x.dim() - 1)))


def batched_rollout(state: ClusterState, profiles, t0, noise, events,
                    det_cfg=None, fc_cfg=None, fleet: FleetParams = None,
                    devices: int = None, use_fused: bool = False):
    """Evaluate one placement/action plan under many simulation seeds.

    The seed axis folds into the node axis: no operation of the window
    scan crosses node rows, so B seeds of N nodes run as one state of B*N
    rows (row ``n + b*N`` is node ``n`` of seed ``b``) and every kernel
    launch covers all of them.

    state: one ``ClusterState`` shared by every seed, or a stacked one
        with a leading (B,) axis on every field.  Neither is written.
    noise: B per-seed chunk-noise streams (``SeedNoise``, or any iterable
        of per-chunk ``TickNoise`` lists), the counterpart of JAX's
        (B, W, C, 2) keys.
    events: ``extract_plan`` output, shared across the batch.
    fleet: per-node delay-curve parameters shared across the batch;
        ``None`` means ``FleetParams.uniform``.
    devices: JAX's shard count, clamped as JAX clamps it to the cards
        the runtime exposes (one for a CPU state).  A request that clamps
        to one card gives the single-device result, as JAX's does; one
        that would shard across several raises, because sharding seeds
        across cards is not ported yet.
    use_fused: run the fused ``rollout_tick`` kernel tick (JAX's
        ``use_pallas``); the default ``_tick`` is the reference.

    Returns (final, outs) with a leading B axis on every per-seed leaf:
    ``outs`` has the RT series (B, W, C*CHUNK, N, S_ON), window-mean
    qps (B, W, N, S_ON), cpu/mem util and hotspot flags (B, W, N).  These
    are views of row-major buffers (the RT buffer is written tick by tick),
    so they are not contiguous.
    """
    _check_shards(devices, state.device)
    batch = len(noise)
    stacked = state.cpu_sum.dim() == 2
    num_nodes = state.cpu_sum.shape[-1]
    device = state.device
    if stacked:
        if state.cpu_sum.shape[0] != batch:
            raise ValueError(
                f"stacked state has {state.cpu_sum.shape[0]} seeds, noise "
                f"has {batch}")
        flat = ClusterState(**{k: v.reshape(batch * num_nodes, *v.shape[2:])
                               for k, v in vars(state).items()})
    else:
        flat = ClusterState(**{k: _tile(v, batch)
                               for k, v in vars(state).items()})
    if fleet is None:
        fleet = FleetParams.uniform(num_nodes, device=device)
    fleet = FleetParams(**{k: _tile(v, batch) for k, v in vars(fleet).items()})
    det, fc = fold_configs(det_cfg, fc_cfg)
    final, outs = scan_windows(
        flat, profiles, fleet, float(t0), batched_noise(list(noise)), events,
        det, fc, init_fold_state(batch * num_nodes, device=device),
        use_fused=use_fused, batch=batch)

    def seeds_first(x: torch.Tensor, lead: int) -> torch.Tensor:
        # (lead..., B*N, rest...) -> (B, lead..., N, rest...)
        shape = x.shape[:lead] + (batch, num_nodes) + x.shape[lead + 1:]
        return x.view(shape).movedim(lead, 0)

    outs = {k: seeds_first(v, 2 if k == "rt" else 1) for k, v in outs.items()}
    fold = {k: seeds_first(v, 0) for k, v in final.items()
            if isinstance(v, torch.Tensor)}
    fold["state"] = ClusterState(**{k: seeds_first(v, 0)
                                    for k, v in vars(final["state"]).items()})
    fold["t"] = torch.full((batch,), final["t"], dtype=torch.float32,
                           device=device)
    fold["det_steps"] = final["det_steps"]
    return fold, outs
