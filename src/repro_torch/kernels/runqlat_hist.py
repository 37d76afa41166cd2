"""The runqlat histogram kernel: wrapper, plain version and launch count.

``runqlat_hist`` is the port of ``repro/kernels/runqlat_hist.py::
runqlat_hist_pallas``, the kernel form of ``metric.histogram``: (S, N)
latency samples and optional weights -> (S, 200) float32 counts, bins 5
wide, clamped to [0, 199].  The kernel itself is CUDA C++ in
``csrc/runqlat_hist.cu`` (design and bound are noted there).

For a tensor on the CPU the wrapper takes ``runqlat_hist_plain``.  For a
CUDA tensor it launches the kernel or raises: there is no fallback.
``launches`` counts kernel launches (and nothing else), so a run can show
that its main path went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

NUM_BINS = 200
BIN_WIDTH = 5.0
_SAMPLES_PER_BLOCK = 2048          # a block takes whole series up to this
_MAX_SERIES_PER_BLOCK = 32         # 32 x 800 B = 25.6 KB of shared memory

launches = 0


def runqlat_hist_plain(samples: torch.Tensor,
                       weights: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version: ``scatter_add_`` of the clamped bin index."""
    idx = torch.clamp(torch.floor(samples / BIN_WIDTH), 0,
                      NUM_BINS - 1).long()
    w = torch.ones_like(samples) if weights is None else weights
    out = torch.zeros((samples.shape[0], NUM_BINS), dtype=torch.float32,
                      device=samples.device)
    return out.scatter_add_(1, idx, w)


def _check(samples: torch.Tensor, weights: torch.Tensor | None) -> None:
    if samples.dim() != 2 or samples.dtype != torch.float32:
        raise ValueError(
            f"samples must be (S, N) float32, got {tuple(samples.shape)} "
            f"{samples.dtype}")
    if not samples.is_contiguous():
        raise ValueError("samples must be contiguous")
    if samples.numel() >= 2**31:
        raise ValueError("samples too large for 32-bit indexing")
    if weights is not None:
        if (weights.shape != samples.shape or weights.dtype != torch.float32
                or weights.device != samples.device):
            raise ValueError(
                "weights must match samples in shape, dtype and device")
        if not weights.is_contiguous():
            raise ValueError("weights must be contiguous")


def _entry():
    fn = build.load("runqlat_hist").runqlat_hist_launch
    if fn.argtypes is None:  # pointers and the stream as c_void_p, not int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _launch(samples: torch.Tensor, weights: torch.Tensor | None):
    global launches
    fn = _entry()
    num_series, n = samples.shape
    out = torch.empty((num_series, NUM_BINS), dtype=torch.float32,
                      device=samples.device)
    if num_series == 0:
        return out
    spb = max(1, min(_MAX_SERIES_PER_BLOCK, _SAMPLES_PER_BLOCK // max(n, 1)))
    dev, stream = build.device_and_stream(samples)
    err = fn(samples.data_ptr(),
             None if weights is None else weights.data_ptr(),
             out.data_ptr(), num_series, n, spb, dev, stream)
    if err != 0:
        raise RuntimeError(f"runqlat_hist launch failed: CUDA error {err}")
    launches += 1
    return out


def runqlat_hist(samples: torch.Tensor,
                 weights: torch.Tensor | None = None) -> torch.Tensor:
    """samples, weights: (S, N) float32 -> (S, 200) float32 histograms."""
    _check(samples, weights)
    if samples.device.type == "cpu":
        return runqlat_hist_plain(samples, weights)
    if samples.device.type != "cuda":
        raise ValueError(f"runqlat_hist: unsupported device {samples.device}")
    return _launch(samples, weights)
