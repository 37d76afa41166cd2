"""The fused rollout-tick kernel: wrapper, plain version and launch count.

``fused_tick`` is the port of ``repro/kernels/rollout_tick.py::fused_tick``
(body ``_tick_kernel``): one tick's per-node delay curve, Erlang(2) runqlat
draw and node histogram in one pass.  The kernel itself is CUDA C++ in
``csrc/rollout_tick.cu`` (design and bound are noted there).  Inputs are
packed as the JAX kernel takes them (``cluster.state._tick_fused`` packs
them from one tick's state and noise):

* ``nodev`` (R, 8) -- [rho_p, threads_total, cores, delay_base,
  delay_scale, rho_knee, oversub_slope, delay_noise] per node row
* ``jit_all`` (R, S) -- per-slot pod jitter, online slots first
* ``act_all`` (R, S) -- slot-active mask as float32
* ``u1`` / ``u2`` (R, S*K) -- Erlang(2) uniforms, K samples per slot

Outputs: node histogram (R, 200), clipped delay (R,), per-slot runqlat
mean (R, S), all float32.

For tensors on the CPU the wrapper takes ``fused_tick_plain``, the same
math in torch operations (binning with ``scatter_add_``, not the JAX
reference's (R, S*K, 200) one-hot).  For CUDA tensors it launches the
kernel or raises: there is no fallback.  ``launches`` counts kernel
launches and nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.runqlat_hist import (
    BIN_WIDTH,
    NUM_BINS,
    runqlat_hist_plain,
)

NODE_FIELDS = 8
CLIP_MAX = 2.5 * (NUM_BINS - 1) * BIN_WIDTH

launches = 0


def _node_delay(nodev: torch.Tensor) -> torch.Tensor:
    """Delay curve x oversubscription x lognormal jitter from the packed
    (R, 8) node vector, in the JAX kernel's order (``scale * rho * rho``,
    a product, not a pow)."""
    rho, thr, cores, base, scale, knee, slope, noise = nodev.unbind(-1)
    d = base + scale * rho * rho / torch.maximum(1.0 - rho, knee)
    d = d * (1.0 + slope * torch.clamp_min(thr / cores - 1.0, 0.0))
    return d * torch.exp(0.13 * noise)


def fused_tick_plain(nodev, jit_all, act_all, u1, u2, *,
                     gamma_shape: float = 2.0, clip_max: float = CLIP_MAX):
    """Plain PyTorch version: the same arithmetic, ``scatter_add_`` bins."""
    rows, slots = jit_all.shape
    k = u1.shape[1] // slots
    d = torch.clamp(_node_delay(nodev), 0.0, clip_max)
    mean = d[:, None] * torch.clamp_min(jit_all, 0.3)
    g = -torch.log(u1 * u2)
    samples = g.view(rows, slots, k) * (mean / gamma_shape)[:, :, None]
    w = act_all[:, :, None].expand(rows, slots, k)
    hist = runqlat_hist_plain(samples.reshape(rows, slots * k),
                              w.reshape(rows, slots * k))
    return hist, d, mean


def _check(nodev, jit_all, act_all, u1, u2) -> None:
    tensors = (nodev, jit_all, act_all, u1, u2)
    if any(t.dim() != 2 or t.dtype != torch.float32 for t in tensors):
        raise ValueError("fused_tick: every input must be 2-D float32")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError("fused_tick: every input must be contiguous")
    if any(t.device != nodev.device for t in tensors):
        raise ValueError("fused_tick: every input must be on one device")
    rows, slots = jit_all.shape
    if nodev.shape != (rows, NODE_FIELDS) or act_all.shape != (rows, slots):
        raise ValueError(
            f"fused_tick: nodev must be ({rows}, {NODE_FIELDS}) and act_all "
            f"({rows}, {slots}), got {tuple(nodev.shape)} and "
            f"{tuple(act_all.shape)}")
    if (slots == 0 or u1.shape != u2.shape or u1.shape[0] != rows
            or u1.shape[1] == 0 or u1.shape[1] % slots):
        raise ValueError(
            f"fused_tick: u1 and u2 must both be ({rows}, {slots}*K), got "
            f"{tuple(u1.shape)} and {tuple(u2.shape)}")
    if u1.numel() >= 2**31:
        raise ValueError("fused_tick: inputs too large for 32-bit indexing")


def _entry():
    fn = build.load("rollout_tick").rollout_tick_launch
    if fn.argtypes is None:  # pointers and the stream as c_void_p, not int
        fn.argtypes = [ctypes.c_void_p] * 8 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _launch(nodev, jit_all, act_all, u1, u2, gamma_shape, clip_max):
    global launches
    fn = _entry()
    rows, slots = jit_all.shape
    dev = nodev.device
    hist = torch.empty((rows, NUM_BINS), dtype=torch.float32, device=dev)
    delay = torch.empty((rows,), dtype=torch.float32, device=dev)
    mean = torch.empty((rows, slots), dtype=torch.float32, device=dev)
    if rows == 0:
        return hist, delay, mean
    index, stream = build.device_and_stream(nodev)
    err = fn(nodev.data_ptr(), jit_all.data_ptr(), act_all.data_ptr(),
             u1.data_ptr(), u2.data_ptr(), hist.data_ptr(), delay.data_ptr(),
             mean.data_ptr(), rows, slots, u1.shape[1] // slots,
             float(gamma_shape), float(clip_max), index, stream)
    if err != 0:
        raise RuntimeError(f"rollout_tick launch failed: CUDA error {err}")
    launches += 1
    return hist, delay, mean


def fused_tick(nodev, jit_all, act_all, u1, u2, *, gamma_shape: float = 2.0,
               clip_max: float = CLIP_MAX):
    """Fused delay curve + Erlang(2) draw + node histogram for one tick.

    Returns ``(hist (R, 200), delay (R,), mean (R, S))``.
    """
    _check(nodev, jit_all, act_all, u1, u2)
    if nodev.device.type == "cpu":
        return fused_tick_plain(nodev, jit_all, act_all, u1, u2,
                                gamma_shape=gamma_shape, clip_max=clip_max)
    if nodev.device.type != "cuda":
        raise ValueError(f"fused_tick: unsupported device {nodev.device}")
    return _launch(nodev, jit_all, act_all, u1, u2, gamma_shape, clip_max)
