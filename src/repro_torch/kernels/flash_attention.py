"""Flash attention: wrapper, plain version and launch count.

``flash_attention`` is the port of ``repro/kernels/flash_attention.py::
flash_attention_pallas`` (body ``_flash_kernel``): forward attention over
(B, S, H, hd) queries with an online softmax in float32, scale
``1 / sqrt(hd)``, causal and sliding-window masks (``-1e30`` for masked
scores), the KV loop stopped at the causal frontier, and the output in
q's type.  Two CUDA C++ kernels compute it (design and bound are noted in
each): bfloat16 inputs go to ``csrc/flash_attention_sm90.cu`` (wgmma on
the tensor cores, fed by TMA; P is rounded to bf16 for O += P V), float32
inputs to ``csrc/flash_attention.cu`` (products on the float32 CUDA
cores, which keep the TPU kernel's float32 arithmetic).  Each reads KV
head ``h // (H // KV)`` for query head ``h``, which is the same function as
JAX's ``_repeat_kv`` followed by the TPU kernel, and masks a ragged tail
itself, so any S works.

For tensors on the CPU the wrapper takes ``flash_attention_plain``, exact
masked-softmax attention in float32 (``ref.flash_attention_ref`` with GQA
and the TPU kernel's masks).  For CUDA tensors it launches the kernel or
raises: there is no fallback, and no kernel is tried after another.
``launches`` counts kernel launches of either kernel and nothing else.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
HEAD_DIMS = (64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

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


# bf16 takes the wgmma/TMA kernel, float32 the SIMT one (its products in
# full float32, which TF32 tensor cores would not keep)
_ENTRIES = {torch.bfloat16: ("flash_attention_sm90",
                             "flash_attention_sm90_launch"),
            torch.float32: ("flash_attention", "flash_attention_launch")}


def _entry(dtype):
    lib, name = _ENTRIES[dtype]
    fn = getattr(build.load(lib), name)
    if fn.argtypes is None:  # pointers and the stream as c_void_p, not int
        ints = 8 if dtype == torch.bfloat16 else 9  # + dtype for the SIMT one
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * ints + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _launch(q, k, v, causal: bool, sliding_window: int) -> torch.Tensor:
    global launches
    B, S, H, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes hd in {HEAD_DIMS}, "
                         f"got {hd}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must be 16-byte "
                             "aligned")
    if max(q.numel(), k.numel()) >= 2**31:
        raise ValueError("flash_attention: too large for 32-bit indexing")
    fn = _entry(q.dtype)
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    dev, stream = build.device_and_stream(q)
    head = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, H,
            k.shape[2], hd, int(causal), sliding_window]
    if q.dtype == torch.float32:
        head.append(_DTYPES[q.dtype])
    err = fn(*head, dev, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    launches += 1
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
