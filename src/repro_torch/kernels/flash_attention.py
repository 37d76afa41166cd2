"""Flash attention: wrapper, plain version and launch count.

``flash_attention`` is the port of ``repro/kernels/flash_attention.py::
flash_attention_pallas`` (body ``_flash_kernel``): forward attention over
(B, S, H, hd) queries with an online softmax in float32, scale
``1 / sqrt(hd)``, causal and sliding-window masks (``-1e30`` for masked
scores), the KV loop stopped at the causal frontier, and the output in
q's type.  Two CUDA C++ kernels compute it (design and bound are noted in
each), on a fixed route by dtype, at every width JAX's configs use (8, 16,
64, 80, 128, 256):

* bfloat16 goes to ``csrc/flash_attention_sm90.cu`` (wgmma on the tensor
  cores, fed by TMA; P is rounded to bf16 for O += P V; a width that is
  not a multiple of 64 is carried in tiles of 64 or 128 columns that TMA
  fills with zeros past hd);
* float32 goes to ``csrc/flash_attention_f32_sm90.cu`` (mma.sync on the
  TF32 tensor cores in 3xTF32: each operand split into two TF32 parts and
  three products summed, which keeps float32 accuracy; P stays float32);
* any other width raises.

``csrc/flash_attention.cu`` (``SIMT``), the first kernel, with its
products on the float32 CUDA cores, is on no route: it is built and called
only to time it beside its replacements on the same inputs.

The route is chosen from the dtype and width alone: no kernel is tried after
another fails.  Each kernel reads KV head ``h // (H // KV)`` for query
head ``h``, which is the same function as JAX's ``_repeat_kv`` followed by
the TPU kernel, and masks a ragged tail itself, so any S works.

For tensors on the CPU the wrapper takes ``flash_attention_plain``, exact
masked-softmax attention in float32 (``ref.flash_attention_ref`` with GQA
and the TPU kernel's masks).  For CUDA tensors it launches the routed
kernel or raises: there is no fallback.
``launches`` counts kernel launches of either kernel and nothing else,
``kernel_launches`` the same launches by kernel.

The forward kernels also write each row's log-sum-exp ``lse`` (B, H, S),
float32, in natural-log units (JAX's ``_flash_fwd`` residuals ``m`` and
``l`` as ``m + log(max(l, 1e-30))``) when asked (``return_lse=True``); every
other caller passes a null pointer and the kernels write nothing more.

The backward (training) is ``flash_attention_bwd``: dq, dk and dv of the
same function from the forward's ``lse``, JAX's
``repro/models/attention.py::_flash_bwd`` formulas (the custom-VJP backward
of ``flash_mha``; no Pallas kernel).  On CUDA tensors it launches, by dtype
alone as the forward does, ``csrc/flash_attention_bwd_sm90.cu`` (bf16:
wgmma fed by TMA) or ``csrc/flash_attention_bwd_f32_sm90.cu`` (float32:
3xTF32 ``mma.sync``), each three kernels with no atomics (D = rowsum(dO o),
then dk / dv, then dq; ``bwd_launches`` counts each launch,
``bwd_kernel_launches`` them by library).  ``csrc/flash_attention_bwd.cu``
(``BWD_SIMT``), the first backward with its products on the float32 CUDA
cores, is on no route: it is built and called only to time it beside its
replacements.  On CPU tensors it takes ``flash_attention_bwd_plain``, those
formulas in float32 written out.  ``FlashAttention`` is the
``torch.autograd.Function`` that joins the two: its forward is
``flash_attention`` with ``lse``, its backward ``flash_attention_bwd``, so
a CUDA tensor is differentiated by the kernels or not at all.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
HEAD_DIMS = (8, 16, 64, 80, 128, 256)   # every width, either kernel
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}   # the SIMT entry's codes

launches = 0


def _keep(S: int, causal: bool, sliding_window: int, device) -> torch.Tensor:
    """(S, S) bool, True where query i attends key j: j <= i if causal,
    j > i - window - 1 with a window."""
    qi = torch.arange(S, device=device)[:, None]
    ki = torch.arange(S, device=device)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=device)
    if causal:
        mask &= qi >= ki
    if sliding_window > 0:
        mask &= ki > qi - sliding_window - 1
    return mask


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, sliding_window: int = 0,
                          return_lse: bool = False):
    """q: (B, S, H, hd); k, v: (B, S, KV, hd) with H % KV == 0 -> like q;
    with ``return_lse`` also the rows' log-sum-exp (B, H, S) float32,
    ``m + log(max(l, 1e-30))`` over the masked scores as JAX's residuals."""
    B, S, H, hd = q.shape
    G = H // k.shape[2]
    kf = k.float().repeat_interleave(G, dim=2)
    vf = v.float().repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * (1.0 / math.sqrt(hd))
    s = torch.where(_keep(S, causal, sliding_window, q.device), s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, vf).to(q.dtype)
    if not return_lse:
        return out
    m = s.amax(-1)
    lse = m + torch.exp(s - m[..., None]).sum(-1).clamp_min(1e-30).log()
    return out, lse


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           sliding_window: int) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q (B, S, H, hd) and k, v (B, S, KV, hd) expected, "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, S, H, hd = q.shape
    if k.shape[:2] != (B, S) or k.shape[3] != hd or H % k.shape[2]:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise ValueError(f"q, k, v must share float32 or bfloat16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must lie on one device")
    if sliding_window < 0:
        raise ValueError(f"sliding_window must be >= 0, got {sliding_window}")


# (library, symbol, pointer arguments, int arguments): the tensor-core
# entries take the lse pointer (null: none written), the SIMT entry has none
# and takes the dtype code
SM90 = ("flash_attention_sm90", "flash_attention_sm90_launch", 5, 8)
F32 = ("flash_attention_f32_sm90", "flash_attention_f32_sm90_launch", 5, 8)
SIMT = ("flash_attention", "flash_attention_launch", 4, 9)
_ROUTE = {torch.bfloat16: SM90, torch.float32: F32}

# launches by kernel (library name), beside their sum ``launches``
kernel_launches = {SM90[0]: 0, F32[0]: 0}


def route(dtype, hd: int):
    """The kernel that takes (dtype, hd): bf16 the wgmma kernel, float32
    the 3xTF32 one, at every width of ``HEAD_DIMS``; raises for another
    width or dtype."""
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes hd in {HEAD_DIMS}, "
                         f"got {hd}")
    if dtype not in _ROUTE:
        raise ValueError(f"flash_attention kernel takes float32 or bfloat16, "
                         f"got {dtype}")
    return _ROUTE[dtype]


def _entry(kernel):
    lib, name, pointers, ints = kernel
    fn = getattr(build.load(lib), name)
    if fn.argtypes is None:  # pointers and the stream as c_void_p, not int
        fn.argtypes = [ctypes.c_void_p] * pointers + [ctypes.c_int] * ints + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _launch(q, k, v, causal: bool, sliding_window: int,
            return_lse: bool = False):
    global launches
    B, S, H, hd = q.shape
    kernel = route(q.dtype, hd)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must be 16-byte "
                             "aligned")
    if max(q.numel(), k.numel()) >= 2**31:
        raise ValueError("flash_attention: too large for 32-bit indexing")
    fn = _entry(kernel)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32,
                      device=q.device) if return_lse else None
    if q.numel() == 0:
        return (out, lse) if return_lse else out
    dev, stream = build.device_and_stream(q)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             None if lse is None else lse.data_ptr(), B, S, H, k.shape[2],
             hd, int(causal), sliding_window, dev, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    launches += 1
    kernel_launches[kernel[0]] += 1
    return (out, lse) if return_lse else out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, sliding_window: int = 0,
                    return_lse: bool = False):
    """q: (B, S, H, hd); k, v: (B, S, KV, hd) -> (B, S, H, hd) like q, and
    with ``return_lse`` the rows' log-sum-exp (B, H, S) float32 beside it."""
    _check(q, k, v, sliding_window)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal,
                                     sliding_window=sliding_window,
                                     return_lse=return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return _launch(q, k, v, causal, sliding_window, return_lse)


# ------------------------------------------------------------- backward --

# (library, symbol) by dtype; the SIMT backward on no route
BWD_SM90 = ("flash_attention_bwd_sm90", "flash_attention_bwd_sm90_launch")
BWD_F32 = ("flash_attention_bwd_f32_sm90",
           "flash_attention_bwd_f32_sm90_launch")
BWD_SIMT = ("flash_attention_bwd", "flash_attention_bwd_launch")
_BWD_ROUTE = {torch.bfloat16: BWD_SM90, torch.float32: BWD_F32}
BWD_LAUNCHES_PER_CALL = 3      # D = rowsum(dO o), dk / dv, dq
BWD_PAD = 64                   # the scratch rows' padding (the kernels')
bwd_launches = 0
# launches by kernel (library name), beside their sum ``bwd_launches``
bwd_kernel_launches = {BWD_SM90[0]: 0, BWD_F32[0]: 0}


def bwd_route(dtype, hd: int):
    """The backward kernel that takes (dtype, hd): bf16 the wgmma kernel,
    float32 the 3xTF32 one, at every width of ``HEAD_DIMS``; raises for
    another width or dtype."""
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention_bwd kernel takes hd in "
                         f"{HEAD_DIMS}, got {hd}")
    if dtype not in _BWD_ROUTE:
        raise ValueError(f"flash_attention_bwd kernel takes float32 or "
                         f"bfloat16, got {dtype}")
    return _BWD_ROUTE[dtype]


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, out: torch.Tensor,
                              dout: torch.Tensor, lse=None, *,
                              causal: bool = True, sliding_window: int = 0):
    """JAX's ``_flash_bwd`` in float32 with GQA: q, out, dout (B, S, H,
    hd), k, v (B, S, KV, hd) -> (dq, dk, dv) in the inputs' types.  The
    forward's ``lse`` is taken for the kernels' signature and not read: m
    and l are recomputed here.

    p = exp(s - m) / max(l, 1e-30) over the kept scores (masked ones
    -1e30, as the forward), D = rowsum(dout out), ds = p (dout v^T - D),
    dq = ds k / sqrt(hd), dk = ds^T q / sqrt(hd), dv = p^T dout; dk and dv
    summed over the H / KV query heads of each KV head."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    qf, of, dof = q.float(), out.float(), dout.float()
    kf = k.float().repeat_interleave(G, dim=2)
    vf = v.float().repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    s = torch.where(_keep(S, causal, sliding_window, q.device), s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    e = torch.exp(s - m)
    p = e / e.sum(-1, keepdim=True).clamp_min(1e-30)
    D = (dof * of).sum(-1).transpose(1, 2)[..., None]       # (B, H, S, 1)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - D)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    dk = dk.reshape(B, S, KV, G, hd).sum(3)
    dv = dv.reshape(B, S, KV, G, hd).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _bwd_entry(kernel):
    lib, name = kernel
    fn = getattr(build.load(lib), name)
    if fn.argtypes is None:  # pointers and the stream as c_void_p
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _launch_bwd(q, k, v, out, dout, lse, causal: bool, sliding_window: int):
    global bwd_launches
    B, S, H, hd = q.shape
    KV = k.shape[2]
    kernel = bwd_route(q.dtype, hd)
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out),
                    ("dout", dout), ("lse", lse)):
        if not t.is_contiguous():
            raise ValueError(f"flash_attention_bwd: {name} must be "
                             "contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention_bwd: {name} must be 16-byte "
                             "aligned")
    if max(q.numel(), k.numel()) >= 2**31:
        raise ValueError("flash_attention_bwd: too large for 32-bit "
                         "indexing")
    fn = _bwd_entry(kernel)
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    if q.numel() == 0:
        return dq, dk, dv
    Sp = -(-S // BWD_PAD) * BWD_PAD
    ws = torch.empty(2 * B * H * Sp, dtype=torch.float32, device=q.device)
    dev, stream = build.device_and_stream(q)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             dout.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
             dv.data_ptr(), ws.data_ptr(), B, S, H, KV, hd, int(causal),
             sliding_window, dev, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd launch failed: CUDA error "
                           f"{err}")
    bwd_launches += BWD_LAUNCHES_PER_CALL
    bwd_kernel_launches[kernel[0]] += BWD_LAUNCHES_PER_CALL
    return dq, dk, dv


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, dout: torch.Tensor,
                        lse: torch.Tensor, *, causal: bool = True,
                        sliding_window: int = 0):
    """dq, dk, dv of ``flash_attention(q, k, v)`` whose output is ``out``
    and log-sum-exp ``lse`` (B, H, S) float32, for the output gradient
    ``dout`` (shaped and typed as q)."""
    _check(q, k, v, sliding_window)
    for name, t in (("out", out), ("dout", dout)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"flash_attention_bwd: {name} "
                             f"{tuple(t.shape)} {t.dtype} on {t.device} "
                             f"does not match q {tuple(q.shape)} {q.dtype} "
                             f"on {q.device}")
    B, S, H, _ = q.shape
    if (lse.shape != (B, H, S) or lse.dtype != torch.float32
            or lse.device != q.device):
        raise ValueError(f"flash_attention_bwd: lse {tuple(lse.shape)} "
                         f"{lse.dtype} on {lse.device}, expected "
                         f"{(B, H, S)} float32 on {q.device}")
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, dout, lse,
                                         causal=causal,
                                         sliding_window=sliding_window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd: unsupported device "
                         f"{q.device}")
    return _launch_bwd(q, k, v, out, dout, lse, causal, sliding_window)


class FlashAttention(torch.autograd.Function):
    """``flash_attention`` with its gradient: the forward wrapper with its
    log-sum-exp, then ``flash_attention_bwd`` on the saved q, k, v, output
    and lse (JAX's ``flash_mha`` custom VJP and its residuals).  On CUDA
    tensors both directions launch kernels or raise."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, sliding_window: int):
        out, lse = flash_attention(q, k, v, causal=causal,
                                   sliding_window=sliding_window,
                                   return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.sliding_window = causal, sliding_window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(
            q, k, v, out, dout.contiguous(), lse, causal=ctx.causal,
            sliding_window=ctx.sliding_window)
        return dq, dk, dv, None, None
