"""Gradient compression for the data-parallel all-reduce.

Port of ``repro.optim.compress``: int8 block quantization with error
feedback.  Gradients are quantized per block of 256 values with a float32
scale (the block's largest magnitude / 127, at least 1e-12), rounded half
to even (``torch.round``, as ``jnp.round``), and the quantization error is
carried to the next step.  Every step is an IEEE float32 operation in
JAX's order, so on the same float32 gradients the int8 values, scales and
carried errors equal JAX's bit for bit.  On one card there is no
all-reduce to shrink; the train step still runs compress -> decompress,
so a run's numbers are those of JAX's step with compression.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

BLOCK = 256
# the values ``compress_roundtrip_`` takes at a time: whole blocks, and
# its half-dozen float32 temporaries near 1.5 GB
CHUNK = BLOCK << 18


def _pad_len(n: int) -> int:
    return (-n) % BLOCK


def compress_leaf(g: torch.Tensor, err: torch.Tensor | None = None):
    """Returns ((q int8 (blocks, 256), scales float32 (blocks, 1)),
    new_err shaped as g).  ``err`` is the carried residual."""
    flat = g.float().reshape(-1)
    if err is not None:
        flat = flat + err.reshape(-1)
    n = flat.numel()
    fp = F.pad(flat, (0, _pad_len(n))).reshape(-1, BLOCK)
    scale = fp.abs().amax(dim=1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(fp / scale), -127, 127).to(torch.int8)
    deq = q.float() * scale
    new_err = (fp - deq).reshape(-1)[:n].reshape(g.shape)
    return (q, scale), new_err


def decompress_leaf(q: torch.Tensor, scale: torch.Tensor, shape,
                    dtype=torch.float32) -> torch.Tensor:
    n = 1
    for s in shape:
        n *= s
    deq = q.float() * scale
    return deq.reshape(-1)[:n].reshape(shape).to(dtype)


def compress_grads(grads: dict, err_state: dict | None = None,
                   groups: list | None = None):
    """Compress a name -> gradient dict.  ``groups`` lists the names whose
    gradients form one leaf, flattened and joined in order (by default
    each name alone): the port keeps a layer's parameters apart where JAX
    stacks a pattern position over its repeats into one leaf, and a
    block of 256 may straddle the stacked layers, so the train step
    passes JAX's leaves to get JAX's blocks and scales.  Returns ([(names,
    (q, scale)), ...], {name: carried error})."""
    groups = [[n] for n in grads] if groups is None else groups
    out, errs = [], {}
    for names in groups:
        flat = torch.cat([grads[n].float().reshape(-1) for n in names])
        err = None if err_state is None else torch.cat(
            [err_state[n].reshape(-1) for n in names])
        qs, new_err = compress_leaf(flat, err)
        out.append((names, qs))
        for n, e in zip(names, new_err.split([grads[n].numel()
                                              for n in names])):
            errs[n] = e.reshape(grads[n].shape)
    return out, errs


def decompress_grads(cgrads: list, like: dict) -> dict:
    """float32 gradients shaped as ``like``'s, from ``compress_grads``."""
    out = {}
    for names, (q, s) in cgrads:
        sizes = [like[n].numel() for n in names]
        flat = decompress_leaf(q, s, (sum(sizes),), torch.float32)
        for n, part in zip(names, flat.split(sizes)):
            out[n] = part.reshape(like[n].shape)
    return out


def _pieces(flats: list, lo: int, hi: int):
    """(tensor index, its start, its end, the start in [lo, hi)) of each
    tensor's part in values lo..hi of ``flats`` joined."""
    start = 0
    for i, t in enumerate(flats):
        end = start + t.numel()
        if end > lo and start < hi:
            a, b = max(lo, start), min(hi, end)
            yield i, a - start, b - start, a - lo
        start = end


def _join(flats: list, lo: int, hi: int) -> torch.Tensor:
    parts = [flats[i][a:b] for i, a, b, _ in _pieces(flats, lo, hi)]
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def _split_into(flats: list, lo: int, hi: int, src: torch.Tensor) -> None:
    for i, a, b, at in _pieces(flats, lo, hi):
        flats[i][a:b].copy_(src[at:at + b - a])


def compress_roundtrip_(grads: dict, err_state: dict | None,
                        groups: list | None = None) -> dict:
    """What ``compress_grads`` then ``decompress_grads`` give, a group at a
    time, so that no temporary spans more than one group or CHUNK values:
    each float32 gradient of ``grads`` becomes its decompressed value and
    each carried error of ``err_state`` its new value (in a new dict when
    ``err_state`` is None).  A group of at most CHUNK values is taken
    whole, and its entries replaced by views of the new values; a larger
    one is written in place, CHUNK values at a time.  CHUNK is whole blocks
    and a group's blocks start at its first value, so every block holds the
    values it holds in ``compress_grads``: the same bits.  Returns the
    carried errors."""
    groups = [[n] for n in grads] if groups is None else groups
    fresh = err_state is None
    errs = {} if fresh else err_state
    for names in groups:
        gs = [grads[n].reshape(-1) for n in names]
        sizes = [g.numel() for g in gs]
        total = sum(sizes)
        if total <= CHUNK:
            (q, scale), new_err = compress_leaf(
                _join(gs, 0, total),
                None if fresh else _join([errs[n].reshape(-1)
                                          for n in names], 0, total))
            deq = decompress_leaf(q, scale, (total,))
            for n, d, e in zip(names, deq.split(sizes), new_err.split(sizes)):
                grads[n] = d.view(grads[n].shape)
                errs[n] = e.view(grads[n].shape)
            continue
        if fresh:
            for n in names:
                errs[n] = torch.empty(grads[n].shape, dtype=torch.float32,
                                      device=grads[n].device)
        gs = [grads[n].view(-1) for n in names]
        es = [errs[n].view(-1) for n in names]
        for lo in range(0, total, CHUNK):
            hi = min(lo + CHUNK, total)
            (q, scale), new_err = compress_leaf(
                _join(gs, lo, hi), None if fresh else _join(es, lo, hi))
            _split_into(gs, lo, hi, decompress_leaf(q, scale, (hi - lo,)))
            _split_into(es, lo, hi, new_err)
    return errs
