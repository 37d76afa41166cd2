"""The runqlat histogram kernel: wrappers, plain version and launch count.

``runqlat_hist`` is the port of ``repro/kernels/runqlat_hist.py::
runqlat_hist_pallas``, the kernel form of ``metric.histogram``: (S, N)
latency samples and optional weights -> (S, 200) float32 counts, bins 5
wide, clamped to [0, 199].  ``runqlat_hist_segments`` bins several such
sets in one kernel launch (the simulator's tick bins its online and
offline slots together); each set's samples and weights may have any
strides, and weights may have stride 0 along the sample axis (a
per-series mask read where it lies).  The kernel itself is CUDA C++ in
``csrc/runqlat_hist.cu`` (design and bound are noted there).  Its arguments
are one ``HistArgs`` struct passed by value, built once per input layout
and only re-pointed on later calls.

For tensors on the CPU the wrappers take ``runqlat_hist_plain`` (set by
set).  For CUDA tensors they launch the kernel or raise: there is no
fallback.  ``launches`` counts kernel launches (and nothing else), so a
run can show that its main path went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

NUM_BINS = 200
BIN_WIDTH = 5.0
MAX_SEGMENTS = 4       # sets one launch takes (kMaxSegments)

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


def _check_segments(segments) -> None:
    if not 1 <= len(segments) <= MAX_SEGMENTS:
        raise ValueError(f"runqlat_hist_segments takes 1 to {MAX_SEGMENTS} "
                         f"sets, got {len(segments)}")
    device = segments[0][0].device
    for samples, weights in segments:
        if samples.dim() != 2 or samples.dtype != torch.float32:
            raise ValueError(
                f"samples must be (S, N) float32, got "
                f"{tuple(samples.shape)} {samples.dtype}")
        if samples.shape[0] >= 2**31 or samples.shape[1] >= 2**31:
            raise ValueError("samples too large for 32-bit counts")
        if samples.device != device:
            raise ValueError("runqlat_hist_segments: every set must lie on "
                             "one device")
        if weights is not None and (
                weights.shape != samples.shape
                or weights.dtype != torch.float32
                or weights.device != device):
            raise ValueError(
                "weights must match samples in shape, dtype and device")


class _Segment(ctypes.Structure):
    """``HistSegment`` of ``csrc/runqlat_hist.cu``."""
    _fields_ = [("samples", ctypes.c_void_p), ("weights", ctypes.c_void_p),
                ("out", ctypes.c_void_p),
                ("sample_stride", ctypes.c_longlong * 2),
                ("weight_stride", ctypes.c_longlong * 2),
                ("num_series", ctypes.c_int), ("n", ctypes.c_int),
                ("series_per_block", ctypes.c_int),
                ("first_block", ctypes.c_int)]


class _HistArgs(ctypes.Structure):
    """``HistArgs`` of ``csrc/runqlat_hist.cu``, passed by value."""
    _fields_ = [("seg", _Segment * MAX_SEGMENTS),
                ("num_segments", ctypes.c_int)]


def _entry():
    fn = build.load("runqlat_hist").runqlat_hist_launch
    if fn.argtypes is None:  # the stream as c_void_p, not int
        fn.argtypes = [_HistArgs, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _hist_args(segments) -> _HistArgs:
    """The kernel's arguments for this layout, pointers included."""
    args = _HistArgs(num_segments=len(segments))
    for seg, (samples, weights) in zip(args.seg, segments):
        seg.sample_stride[:] = samples.stride()
        if weights is not None:
            seg.weight_stride[:] = weights.stride()
        seg.num_series, seg.n = samples.shape
    return args


def _set_pointers(args: _HistArgs, segments, outs) -> None:
    for seg, (samples, weights), out in zip(args.seg, segments, outs):
        seg.samples = samples.data_ptr()
        seg.weights = None if weights is None else weights.data_ptr()
        seg.out = out.data_ptr()


# kernel arguments by layout: the shapes, strides and devices of the sets
# decide everything in the struct but its pointers
_ARGS_BY_LAYOUT: dict = {}


def _layout(segments):
    return tuple((s.shape, s.stride(), s.dtype, s.get_device(),
                  None if w is None else (w.shape, w.stride(), w.dtype,
                                          w.get_device()))
                 for s, w in segments)


def runqlat_hist_segments(segments) -> list[torch.Tensor]:
    """Bin each (samples (S_i, N_i), weights (S_i, N_i) or None) set of
    ``segments`` (1 to 4 sets, any strides) into (S_i, 200) float32
    histograms: one kernel launch for all of them on the card."""
    segments = [tuple(seg) for seg in segments]
    key = _layout(segments)
    args = _ARGS_BY_LAYOUT.get(key)
    if args is None:
        _check_segments(segments)
    device = segments[0][0].device
    if device.type == "cpu":
        return [runqlat_hist_plain(s, w) for s, w in segments]
    if device.type != "cuda":
        raise ValueError(f"runqlat_hist: unsupported device {device}")
    rows = [s.shape[0] for s, _ in segments]
    flat = torch.empty((sum(rows), NUM_BINS), dtype=torch.float32,
                       device=device)
    outs = flat.split(rows)     # 800-byte rows: every part 16-byte aligned
    if sum(rows) == 0:
        return list(outs)
    if args is None:
        args = _hist_args(segments)
        if len(_ARGS_BY_LAYOUT) >= 64:
            _ARGS_BY_LAYOUT.clear()
        _ARGS_BY_LAYOUT[key] = args
    _set_pointers(args, segments, outs)
    _run(args, flat)
    return list(outs)


def _run(args: _HistArgs, out: torch.Tensor) -> None:
    global launches
    fn = _entry()
    index, stream = build.device_and_stream(out)
    err = fn(args, index, stream)
    if err != 0:
        raise RuntimeError(f"runqlat_hist launch failed: CUDA error {err}")
    launches += 1


def runqlat_hist(samples: torch.Tensor,
                 weights: torch.Tensor | None = None) -> torch.Tensor:
    """samples, weights: (S, N) float32, contiguous -> (S, 200) float32
    histograms (one set; ``runqlat_hist_segments`` takes several)."""
    _check(samples, weights)
    if samples.device.type == "cpu":
        return runqlat_hist_plain(samples, weights)
    if samples.device.type != "cuda":
        raise ValueError(f"runqlat_hist: unsupported device {samples.device}")
    return runqlat_hist_segments([(samples, weights)])[0]
