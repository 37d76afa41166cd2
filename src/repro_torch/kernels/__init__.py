"""Hand-written Hopper kernels of the port, each beside its plain version.

| kernel | replaces | source |
| --- | --- | --- |
| ``runqlat_hist`` | ``repro/kernels/runqlat_hist.py::runqlat_hist_pallas`` | ``csrc/runqlat_hist.cu`` |
| ``rollout_tick`` | ``repro/kernels/rollout_tick.py::fused_tick`` | ``csrc/rollout_tick.cu`` |
| ``flash_attention`` | ``repro/kernels/flash_attention.py::flash_attention_pallas`` | ``csrc/flash_attention_sm90.cu`` (bf16), ``csrc/flash_attention_f32_sm90.cu`` (float32) |
| ``flash_attention_bwd`` | none: JAX's custom-VJP backward ``repro/models/attention.py::_flash_bwd`` (plain jnp) | ``csrc/flash_attention_bwd_sm90.cu`` (bf16), ``csrc/flash_attention_bwd_f32_sm90.cu`` (float32) |
| ``ssd`` | ``repro/kernels/ssd.py::ssd_pallas`` | ``csrc/ssd_sm90.cu`` (bf16), ``csrc/ssd.cu`` (float32) |
| ``ssd_bwd`` | none: JAX's autodiff of ``repro/models/ssd.py::ssd_chunked`` (plain jnp) | ``csrc/ssd_bwd_sm90.cu`` (bf16 and float32) |
| ``wkv`` | ``repro/kernels/rwkv_wkv.py::wkv_pallas`` | ``csrc/wkv.cu`` |
| ``wkv_bwd`` | none: JAX's autodiff of ``repro/models/rwkv.py::wkv_chunked`` (plain jnp) | ``csrc/wkv_bwd.cu`` |
"""
from __future__ import annotations

import torch


def plain_dtype(t: torch.Tensor) -> torch.dtype:
    """The type the scans' plain versions compute in: float64 for float64
    inputs (gradcheck and the float64 references), float32 for all others."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def scan_function(name: str, forward, backward, doc: str = ""):
    """A ``torch.autograd.Function`` over a scan: ``forward(*args)`` returns
    (y, final state); ``backward(*tensors, *rest, dy, dstate)`` returns the
    gradients of the tensor arguments, which lead ``args`` (``rest`` are
    the trailing ints).  The inputs are saved and nothing else, so the
    backward recomputes what it needs.  A final state that the caller drops
    (the model in training) has no gradient: None, passed on as None; a
    dropped y's is taken as zero.  ``SSDScan`` and ``WKVScan`` are two such
    Functions; a check builds others that pair a kernel with a plain
    version."""

    class Scan(torch.autograd.Function):
        @staticmethod
        def forward(ctx, *args):
            tensors = [a for a in args if torch.is_tensor(a)]
            ctx.set_materialize_grads(False)
            ctx.save_for_backward(*tensors)
            ctx.rest = args[len(tensors):]
            return forward(*args)

        @staticmethod
        def backward(ctx, dy, dstate):
            saved = ctx.saved_tensors
            dy = torch.zeros_like(saved[0]) if dy is None else dy.contiguous()
            if dstate is not None:
                dstate = dstate.contiguous()
            return (*backward(*saved, *ctx.rest, dy, dstate),
                    *[None] * len(ctx.rest))

    Scan.__name__ = Scan.__qualname__ = name
    Scan.__doc__ = doc
    return Scan
