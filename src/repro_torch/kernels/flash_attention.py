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


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          sliding_window: int = 0) -> torch.Tensor:
    """q: (B, S, H, hd); k, v: (B, S, KV, hd) with H % KV == 0 -> like q."""
    B, S, H, hd = q.shape
    G = H // k.shape[2]
    kf = k.float().repeat_interleave(G, dim=2)
    vf = v.float().repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * (1.0 / math.sqrt(hd))
    qi = torch.arange(S, device=q.device)[:, None]
    ki = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qi >= ki
    if sliding_window > 0:
        mask &= ki > qi - sliding_window - 1
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vf).to(q.dtype)


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


# (library, symbol, int arguments): the SIMT entry takes the dtype code too
SM90 = ("flash_attention_sm90", "flash_attention_sm90_launch", 8)
F32 = ("flash_attention_f32_sm90", "flash_attention_f32_sm90_launch", 8)
SIMT = ("flash_attention", "flash_attention_launch", 9)
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
    lib, name, ints = kernel
    fn = getattr(build.load(lib), name)
    if fn.argtypes is None:  # pointers and the stream as c_void_p, not int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * ints + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _launch(q, k, v, causal: bool, sliding_window: int) -> torch.Tensor:
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
    if q.numel() == 0:
        return out
    dev, stream = build.device_and_stream(q)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S,
             H, k.shape[2], hd, int(causal), sliding_window, dev, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    launches += 1
    kernel_launches[kernel[0]] += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    sliding_window: int = 0) -> torch.Tensor:
    """q: (B, S, H, hd); k, v: (B, S, KV, hd) -> (B, S, H, hd) like q."""
    _check(q, k, v, sliding_window)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal,
                                     sliding_window=sliding_window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return _launch(q, k, v, causal, sliding_window)
