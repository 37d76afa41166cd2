"""The fused rollout-tick kernel: wrapper, plain version and launch count.

``fused_tick`` is the port of ``repro/kernels/rollout_tick.py::fused_tick``
(body ``_tick_kernel``): one tick's per-node delay curve, Erlang(2)
runqlat draw and node histogram in one pass.  The kernel itself is CUDA C++
in ``csrc/rollout_tick.cu`` (design and bound are noted there).  It has two
entries over the same kernel:

* ``fused_tick_unpacked`` reads the tick's tensors where they lie, as
  ``cluster.state._tick_fused`` has them: eight (R,) fields (rho_p,
  threads_total, cores, delay_base, delay_scale, rho_knee, oversub_slope,
  delay noise; any stride), the jitter normals and bool active masks of the
  online and offline slots (R, S_kind) and their uniforms (R, S_kind, K,
  2), each with any row stride.  This is the main path: no packing.
* ``fused_tick`` takes the inputs packed as the JAX kernel takes them:

  * ``nodev`` (R, 8) -- the eight fields above per node row
  * ``jit_all`` (R, S) -- per-slot pod jitter ``1 + 0.18 x``, online first
  * ``act_all`` (R, S) -- slot-active mask as float32
  * ``u1`` / ``u2`` (R, S*K) -- Erlang(2) uniforms, K samples per slot

``pack`` turns the first form into the second.  Outputs: node histogram
(R, 200), clipped delay (R,), per-slot runqlat mean (R, S), all float32.

For tensors on the CPU each wrapper takes its plain version
(``fused_tick_plain``, the same math in torch operations, binning with
``scatter_add_``, not the JAX reference's (R, S*K, 200) one-hot;
``fused_tick_unpacked_plain`` is ``pack`` then ``fused_tick_plain``).  For
CUDA tensors it launches the kernel or raises: there is no fallback.
``launches`` counts kernel launches of either entry and nothing else.
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
MAX_SLOTS = 32  # slots a row the kernel lists (kMaxSlots)
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
    if slots > MAX_SLOTS:
        raise ValueError(f"fused_tick: at most {MAX_SLOTS} slots a row, got "
                         f"{slots}")


class _SlotKind(ctypes.Structure):
    """``SlotKind`` of ``csrc/rollout_tick.cu``: one slot kind's tensors."""
    _fields_ = [("jit", ctypes.c_void_p), ("act", ctypes.c_void_p),
                ("u1", ctypes.c_void_p), ("u2", ctypes.c_void_p),
                ("jit_stride", ctypes.c_longlong),
                ("act_stride", ctypes.c_longlong),
                ("u_stride", ctypes.c_longlong), ("slots", ctypes.c_int)]


class _TickArgs(ctypes.Structure):
    """``TickArgs`` of ``csrc/rollout_tick.cu``, passed by value."""
    _fields_ = [("field", ctypes.c_void_p * NODE_FIELDS),
                ("field_stride", ctypes.c_longlong * NODE_FIELDS),
                ("kind", _SlotKind * 2), ("hist", ctypes.c_void_p),
                ("delay", ctypes.c_void_p), ("mean", ctypes.c_void_p),
                ("rows", ctypes.c_int), ("k", ctypes.c_int),
                ("u_step", ctypes.c_int), ("jit_raw", ctypes.c_int),
                ("act_bool", ctypes.c_int),
                ("gamma_shape", ctypes.c_float), ("clip_max", ctypes.c_float)]


def _entry():
    fn = build.load("rollout_tick").rollout_tick_launch
    if fn.argtypes is None:  # the stream as c_void_p, not int
        fn.argtypes = [_TickArgs, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _outputs(rows, slots, device):
    return (torch.empty((rows, NUM_BINS), dtype=torch.float32, device=device),
            torch.empty((rows,), dtype=torch.float32, device=device),
            torch.empty((rows, slots), dtype=torch.float32, device=device))


def _tick_args(fields, kinds, outs, *, k, u_step, jit_raw, act_bool,
               gamma_shape, clip_max) -> _TickArgs:
    """The kernel's arguments from plain integers (the replay's entry
    builds them once per layout, see ``_ARGS_BY_LAYOUT``).  ``fields``:
    eight (pointer, stride) pairs;
    ``kinds``: two (jit, act, u1, u2, jit_stride, act_stride, u_stride,
    slots) tuples, u1/u2 pointing at the first and second draw of the
    kind's first sample; ``outs``: hist, delay, mean.  Strides are in
    elements."""
    ptrs, strides = zip(*fields)
    return _TickArgs(
        (ctypes.c_void_p * NODE_FIELDS)(*ptrs),
        (ctypes.c_longlong * NODE_FIELDS)(*strides),
        (_SlotKind * 2)(*(_SlotKind(*kind) for kind in kinds)),
        outs[0].data_ptr(), outs[1].data_ptr(), outs[2].data_ptr(),
        outs[1].shape[0], k, u_step, jit_raw, act_bool, gamma_shape,
        clip_max)


def _check_vector_loads(args: _TickArgs) -> None:
    """The kernel loads a slot's uniforms four samples at a time as
    16-byte vectors: K must be a multiple of 4 and each kind's uniforms
    16-byte aligned, row by row (interleaved draws are loaded from u1
    alone)."""
    if args.k % 4:
        raise ValueError(f"rollout_tick kernel takes K % 4 == 0 samples a "
                         f"slot, got K = {args.k}")
    for kind in args.kind:
        if (kind.u1 or 0) % 16 or kind.u_stride % 4 or (
                args.u_step == 1 and (kind.u2 or 0) % 16):
            raise ValueError("rollout_tick kernel: the uniforms must be "
                             "16-byte aligned in every row")


def _run(args: _TickArgs, device_tensor, outs):
    global launches
    _check_vector_loads(args)
    fn = _entry()
    if args.rows == 0:
        return outs
    index, stream = build.device_and_stream(device_tensor)
    err = fn(args, index, stream)
    if err != 0:
        raise RuntimeError(f"rollout_tick launch failed: CUDA error {err}")
    launches += 1
    return outs


def _packed_args(nodev, jit_all, act_all, u1, u2, outs, gamma_shape,
                 clip_max) -> _TickArgs:
    """Arguments for the packed layout: the online kind takes all S slots,
    the offline kind none."""
    slots, n = jit_all.shape[1], u1.shape[1]
    p = nodev.data_ptr()
    fields = [(p + 4 * f, NODE_FIELDS) for f in range(NODE_FIELDS)]
    kinds = [(jit_all.data_ptr(), act_all.data_ptr(), u1.data_ptr(),
              u2.data_ptr(), slots, slots, n, slots),
             (jit_all.data_ptr(), act_all.data_ptr(), u1.data_ptr(),
              u2.data_ptr(), slots, slots, n, 0)]
    return _tick_args(fields, kinds, outs, k=n // slots, u_step=1, jit_raw=0,
                      act_bool=0, gamma_shape=gamma_shape, clip_max=clip_max)


def _unpacked_args(fields, jit_on, jit_off, on_active, off_active, u_on,
                   u_off, outs, gamma_shape, clip_max) -> _TickArgs:
    """Arguments for the tick's own tensors, read where they lie: the second
    draw of a sample sits one float after the first."""
    kinds = [(jit.data_ptr(), act.data_ptr(), u.data_ptr(), u.data_ptr() + 4,
              jit.stride(0), act.stride(0), u.stride(0), jit.shape[1])
             for jit, act, u in ((jit_on, on_active, u_on),
                                 (jit_off, off_active, u_off))]
    return _tick_args([(t.data_ptr(), t.stride(0)) for t in fields], kinds,
                      outs, k=u_on.shape[2], u_step=2, jit_raw=1, act_bool=1,
                      gamma_shape=gamma_shape, clip_max=clip_max)


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
    outs = _outputs(*jit_all.shape, nodev.device)
    return _run(_packed_args(nodev, jit_all, act_all, u1, u2, outs,
                             gamma_shape, clip_max), nodev, outs)


def pack(fields, jit_on, jit_off, on_active, off_active, u_on, u_off):
    """The packed inputs of ``fused_tick`` from the tick's own tensors (JAX
    ``_tick_pallas``'s layout): ``nodev`` (R, 8), jitter and active masks
    (R, S_ON + S_OFF), the two uniforms of each sample (R, S*K) each."""
    rows = jit_on.shape[0]
    nodev = torch.stack(list(fields), dim=-1)
    jit_all = 1.0 + 0.18 * torch.cat([jit_on, jit_off], 1)
    act_all = torch.cat([on_active, off_active], 1).float()
    u = torch.cat([u_on.reshape(rows, -1, 2), u_off.reshape(rows, -1, 2)],
                  dim=1)
    return (nodev, jit_all, act_all, u[..., 0].contiguous(),
            u[..., 1].contiguous())


def fused_tick_unpacked_plain(fields, jit_on, jit_off, on_active, off_active,
                              u_on, u_off, *, gamma_shape: float = 2.0,
                              clip_max: float = CLIP_MAX):
    """Plain version of ``fused_tick_unpacked``: ``pack``, then
    ``fused_tick_plain``."""
    return fused_tick_plain(
        *pack(fields, jit_on, jit_off, on_active, off_active, u_on, u_off),
        gamma_shape=gamma_shape, clip_max=clip_max)


def _check_unpacked(fields, jits, actives, us) -> None:
    if len(fields) != NODE_FIELDS:
        raise ValueError(f"fused_tick_unpacked: {NODE_FIELDS} fields "
                         f"expected, got {len(fields)}")
    rows = fields[0].shape[0] if fields[0].dim() == 1 else -1
    device = fields[0].device
    tensors = [*fields, *jits, *actives, *us]
    if any(t.device != device for t in tensors):
        raise ValueError("fused_tick_unpacked: every input must be on one "
                         "device")
    if any(t.shape != (rows,) or t.dtype != torch.float32 for t in fields):
        raise ValueError("fused_tick_unpacked: the fields must be (R,) "
                         "float32")
    k = us[0].shape[2] if us[0].dim() == 4 else 0
    for jit, act, u in zip(jits, actives, us):
        slots = jit.shape[1] if jit.dim() == 2 else -1
        if (jit.shape != (rows, slots) or jit.dtype != torch.float32
                or act.shape != (rows, slots) or act.dtype != torch.bool
                or u.shape != (rows, slots, k, 2) or k == 0
                or u.dtype != torch.float32):
            raise ValueError(
                f"fused_tick_unpacked: jitter (R, S) float32, active (R, S) "
                f"bool and uniforms (R, S, K, 2) float32 expected, got "
                f"{tuple(jit.shape)} {jit.dtype}, {tuple(act.shape)} "
                f"{act.dtype}, {tuple(u.shape)} {u.dtype}")
        if (slots > 1 and (jit.stride(1) != 1 or act.stride(1) != 1)) or \
                u.stride()[1:] != (2 * k, 2, 1):
            raise ValueError("fused_tick_unpacked: each row of jitter, mask "
                             "and uniforms must be contiguous")
    slots = jits[0].shape[1] + jits[1].shape[1]
    if slots == 0 or slots > MAX_SLOTS:
        raise ValueError(f"fused_tick_unpacked: 1 to {MAX_SLOTS} slots a row, "
                         f"got {slots}")


def _set_pointers(args: _TickArgs, fields, kinds, outs) -> None:
    """Point a cached ``_unpacked_args`` struct at this call's tensors;
    ``kinds``: (jit, act, u) of each slot kind."""
    args.field[:] = [t.data_ptr() for t in fields]
    for kind, (jit, act, u) in zip(args.kind, kinds):
        p = u.data_ptr()
        kind.jit, kind.act, kind.u1, kind.u2 = (jit.data_ptr(),
                                                act.data_ptr(), p, p + 4)
    args.hist, args.delay, args.mean = (outs[0].data_ptr(),
                                        outs[1].data_ptr(), outs[2].data_ptr())


# checked kernel arguments by layout: the shapes, strides, dtypes and
# devices of the inputs and the two floats decide everything in the struct
# but its pointers, so a tick of a layout seen before only rewrites those
_ARGS_BY_LAYOUT: dict = {}


def fused_tick_unpacked(fields, jit_on, jit_off, on_active, off_active, u_on,
                        u_off, *, gamma_shape: float = 2.0,
                        clip_max: float = CLIP_MAX):
    """``fused_tick`` on the tick's tensors where they lie (see the module
    note).  Returns ``(hist (R, 200), delay (R,), mean (R, S_ON + S_OFF))``.
    """
    fields = list(fields)
    kinds = ((jit_on, on_active, u_on), (jit_off, off_active, u_off))
    key = (len(fields), gamma_shape, clip_max, *(
        (t.shape, t.stride(), t.dtype, t.get_device())
        for t in (*fields, *kinds[0], *kinds[1])))
    args = _ARGS_BY_LAYOUT.get(key)
    if args is None:
        _check_unpacked(fields, (jit_on, jit_off), (on_active, off_active),
                        (u_on, u_off))
    device = fields[0].device
    if device.type == "cpu":
        return fused_tick_unpacked_plain(
            fields, jit_on, jit_off, on_active, off_active, u_on, u_off,
            gamma_shape=gamma_shape, clip_max=clip_max)
    if device.type != "cuda":
        raise ValueError(f"fused_tick_unpacked: unsupported device {device}")
    outs = _outputs(jit_on.shape[0], jit_on.shape[1] + jit_off.shape[1],
                    device)
    if args is None:
        args = _unpacked_args(fields, jit_on, jit_off, on_active, off_active,
                              u_on, u_off, outs, gamma_shape, clip_max)
        if len(_ARGS_BY_LAYOUT) >= 64:
            _ARGS_BY_LAYOUT.clear()
        _ARGS_BY_LAYOUT[key] = args
    else:
        _set_pointers(args, fields, kinds, outs)
    return _run(args, fields[0], outs)
