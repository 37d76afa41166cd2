"""Cluster state, pure transforms and the simulator tick, on tensors.

Port of ``repro.cluster.state`` (the main-path part):

* ``ClusterState`` -- a frozen dataclass of the 12 per-node/per-slot
  tensors; ``FleetParams`` -- the four (N,) float32 delay-curve tensors.
* Pure transforms -- ``place_*`` / ``evict_*`` / ``migrate_*`` /
  ``resize_*`` / ``reconcile`` return a new state and never write the one
  they were given, as in the JAX package.
* ``_tick`` -- one 30 s tick: delay curve, Erlang(2) runqlat draws, the
  per-slot histograms (through ``metric.histogram``, i.e. the
  ``runqlat_hist`` kernel on the card), response time and Table-III
  telemetry.  ``_window_core`` runs one tick per noise bundle and reduces
  them; ``rollout_chunks`` runs whole ``CHUNK``-tick chunks;
  ``merge_summaries`` is the host merge of the JAX package.

Randomness has one seam, the ``TickNoise`` bundle: every draw ``_tick``
makes, as standard normals and uniforms in [tiny, 1).  By default the
bundles come from a ``torch.Generator`` on the device
(``draw_noise`` / ``chunk_noise_stream``); tests inject bundles that JAX
drew from the same key, which makes the two packages compute on the same
inputs.

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


def draw_noise(generator: torch.Generator, num_nodes: int,
               num_ticks: int) -> list[TickNoise]:
    """``num_ticks`` bundles from two bulk draws on the generator's device."""
    device = generator.device
    z = torch.randn((num_ticks, num_nodes, _NUM_NORMALS),
                    generator=generator, device=device)
    u = torch.rand((num_ticks, num_nodes, _NUM_UNIFORMS),
                   generator=generator, device=device).clamp_min_(_TINY)
    split = S_ON * SAMPLES_PER_TICK * 2
    out = []
    for i in range(num_ticks):
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


def chunk_noise_stream(generator: torch.Generator, num_nodes: int):
    """Endless per-chunk noise: each item is ``CHUNK`` tick bundles.

    The counterpart of JAX ``chunk_key_stream``: the stream is consumed
    chunk by chunk, so every rollout path that runs the same chunks draws
    the same numbers.
    """
    while True:
        yield draw_noise(generator, num_nodes, CHUNK)


# --------------------------------------------------------------------------
# the tick
# --------------------------------------------------------------------------


def _tick(st: ClusterState, profiles, fleet: FleetParams, t,
          noise: TickNoise | None = None,
          generator: torch.Generator | None = None):
    """One tick.  ``t`` is a 0-d float32 tensor; ``noise`` defaults to a
    bundle drawn from ``generator``.  Returns (new_state, outputs)."""
    if noise is None:
        noise = draw_noise(generator, st.num_nodes, 1)[0]

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
    rho = total_cpu / cores
    rho_p = pressure_cpu / cores
    threads_total = thr_on.sum(-1) + thr_off.sum(-1) + 2.0

    delay = delay_curve(rho_p, base=fleet.delay_base,
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
        w = active[..., None].expand(samples.shape).float()
        return samples, w, mean

    s_on, w_on, mean_on = pod_samples(noise.jit_on, noise.u_on, on_active)
    s_off, w_off, _ = pod_samples(noise.jit_off, noise.u_off, off_active)
    hist_on = metric.histogram(s_on, w_on)     # (N, S_ON, 200)
    hist_off = metric.histogram(s_off, w_off)  # (N, S_OFF, 200)

    cpu_util = torch.minimum(total_cpu, cores) / cores
    mem_used = mem_on.sum(-1) + mem_off.sum(-1) + 2.0
    mem_util = torch.minimum(mem_used, st.mem_sum) / st.mem_sum
    n_pods = on_active.sum(-1) + off_active.sum(-1)

    # online response time: service + queueing delay + cache contention
    base_rt = profiles["base_rt"][on_type]
    sat = torch.clamp_min(qps_t / profiles["qps_cap"][on_type] - 0.8, 0.0)
    mem_press = torch.clamp_max(mem_used / st.mem_sum, 1.2)
    cache_term = 0.06 * base_rt * mem_press[:, None]
    rt = base_rt * (1.0 + 1.5 * sat) \
        + profiles["rt_per_runqlat"][on_type] * mean_on \
        + cache_term \
        + 0.06 * base_rt * noise.rt
    rt = torch.where(on_active, torch.clamp_min(rt, 0.5), 0.0)

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
    off_cpu_sum = cpu_off.sum(-1)
    perf = torch.stack([
        cpu_util,
        mem_util,
        0.25 * mem_used,             # mem_cache
        1500.0 * total_cpu,          # mem_pgfault
        3.0 * mem_off.sum(-1),       # mem_pgmajfault
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
        "cpu_util": cpu_util,
        "mem_util": mem_util,
        "mem_used": mem_used,
        "cpu_demand": total_cpu,
        "hw": hw,
        "perf": perf,
        "delay": delay,
        "mean_on": mean_on,
    }

    # age offline jobs
    new_rem = torch.where(off_active, st.off_remaining - 1, st.off_remaining)
    st = st.replace(off_remaining=new_rem,
                    off_active=off_active & (new_rem > 0))
    return st, out


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
