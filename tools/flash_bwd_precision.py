#!/usr/bin/env python3
"""The float32 backward flash kernel and its plain version against the exact
backward, at a trained model's attention, on one card.

Run from the root of a checkout, on a machine with a CUDA card::

    python3 tools/flash_bwd_precision.py [--arch A] [--forward] [--out FILE]

One architecture of ``chip_smoke.TRAIN_FAMILIES`` (default dbrx-132b) a
run, as the card holds one at a time: its cut is trained as
``chip_smoke.py``'s phase trains it (10 steps, ``train_and_check``),
widened to float32, and one microbatch's loss
differentiated with both flash kernels while the backward's inputs of
layer 0 (q, k, v, out, dout) are kept.  On those inputs dq, dk and dv come
from the kernel (``flash_attention_bwd``), from its plain version in float32
(``flash_attention_bwd_plain``) and from the same formulas in float64,
which is the exact backward of these inputs up to float64 rounding.  Each
float32 result's max error over the float64 result's largest value is
printed, and the same for the wk gradient each dk gives (RoPE's transpose,
then h^T, h the layer's normed input, all in float64), where the sum over
tokens cancels and so amplifies rounding; and the kernel against the plain
version there, which is what ``chip_smoke.py``'s float32 copy holds.

``--forward`` also holds the float32 forward kernel alone against the
float64 forward (out over its largest value, lse in absolute terms), at
random inputs of ``FWD_CASES`` first and then at layer 0's q, k, v, for
each form of its 3xTF32 product (``MMA3``), each built from a copy of
``flash_attention_f32_sm90.cu`` that has that form, beside the plain
version in float32; and times each form at the random inputs (CUDA
events, in the order chained, per_step, per_step, chained).

Prints the card's name and power limit and one JSON line; ``--out FILE``
also writes it to FILE.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def bwd64(torch, q, k, v, out, dout):
    """``flash_attention_bwd_plain``'s formulas, causal, in float64."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    qd, od, dod = q.double(), out.double(), dout.double()
    kd = k.double().repeat_interleave(G, dim=2)
    vd = v.double().repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", qd, kd) * scale
    keep = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    s = torch.where(keep, s, -1e300)
    p = torch.softmax(s, dim=-1)
    D = (dod * od).sum(-1).transpose(1, 2)[..., None]
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dod)
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", dod, vd) - D)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kd) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qd) * scale
    return (dq, dk.reshape(B, S, KV, G, hd).sum(3),
            dv.reshape(B, S, KV, G, hd).sum(3)), ds


def tf32(torch, x):
    """x (float32) rounded to TF32, to nearest with ties away from zero
    (``cvt.rna.tf32.f32``)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split3x(torch, x):
    """x's 3xTF32 operand: hi + lo, each TF32, as float64."""
    hi = tf32(torch, x)
    return hi.double() + tf32(torch, x.float() - hi).double()


def dk_from(torch, ds, q, G):
    """dk of the float64 product of ``ds`` (B, H, S, S) and ``q``, summed
    over each KV head's G query heads."""
    B, S, H, hd = q.shape
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q) / math.sqrt(hd)
    return dk.reshape(B, S, H // G, G, hd).sum(3)


def wk_grad(torch, A, h, dk, theta):
    """The wk gradient a dk (B, S, KV, hd) gives: RoPE's transpose at
    positions 0..S-1 (the rotation's angles as the model computes them),
    then h^T, in float64."""
    B, S, KV, hd = dk.shape
    inv = A.rope_freqs(hd, theta, dk.device)
    ang = torch.arange(S, device=dk.device).float()[:, None] * inv
    sin = torch.sin(ang).double()[None, :, None, :]
    cos = torch.cos(ang).double()[None, :, None, :]
    d1, d2 = dk.double().chunk(2, dim=-1)
    pre = torch.cat([d1 * cos + d2 * sin, d2 * cos - d1 * sin], dim=-1)
    return h.double().reshape(B * S, -1).T @ pre.reshape(B * S, KV * hd)


# the two forms of the float32 forward kernel's 3xTF32 product d += a b:
# the three products chained in d, or summed from zero and added to d in
# float32
MMA3 = {
    "chained": """__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  mma_tf32(d, al, bh[0], bh[1]);
  mma_tf32(d, ah, bl[0], bl[1]);
  mma_tf32(d, ah, bh[0], bh[1]);
}""",
    "per_step": """__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  float p[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(p, al, bh[0], bh[1]);
  mma_tf32(p, ah, bl[0], bl[1]);
  mma_tf32(p, ah, bh[0], bh[1]);
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] += p[e];
}"""}
FWD_LIB = "flash_attention_f32_sm90"
# name, B, S, H, KV, hd (causal): qwen3-moe's attention (GQA 16, hd 64),
# GQA 16 at hd 256, dbrx's (GQA 6, hd 128)
FWD_CASES = [("gqa16_hd64", 4, 1024, 64, 4, 64),
             ("gqa16_hd256", 1, 1024, 16, 1, 256),
             ("gqa6_hd128", 4, 1024, 48, 8, 128)]


def fwd_forms(build):
    """The forward kernel's launch entry in each form of ``MMA3``, each
    built from a patched copy of its source."""
    import ctypes

    src = (build.CSRC / f"{FWD_LIB}.cu").read_text()
    start = src.index("__device__ __forceinline__ void mma3(")
    end = src.index("\n}\n", start) + 2
    dirs = {}
    for form, body in MMA3.items():
        d = build.BUILD_DIR / "variants" / f"mma3_{form}"
        d.mkdir(parents=True, exist_ok=True)
        (d / f"{FWD_LIB}.cu").write_text(src[:start] + body + src[end:])
        dirs[form] = d
    entries = {}
    for form, d in dirs.items():
        fn = getattr(ctypes.CDLL(str(build.build([FWD_LIB], d)[FWD_LIB])),
                     f"{FWD_LIB}_launch")
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        entries[form] = fn
    return entries


def fwd_call(torch, build, fn, q, k, v):
    """One causal launch of a forward entry: (out, lse)."""
    B, S, H, hd = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    dev, stream = build.device_and_stream(q)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             lse.data_ptr(), B, S, H, k.shape[2], hd, 1, 0, dev, stream)
    if err:
        raise RuntimeError(f"forward launch failed: CUDA error {err}")
    return out, lse


def fwd64(torch, q, k, v):
    """The causal forward in float64: out (B, S, H, hd) and the rows'
    log-sum-exp (B, H, S)."""
    B, S, H, hd = q.shape
    G = H // k.shape[2]
    kd = k.double().repeat_interleave(G, dim=2)
    vd = v.double().repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.double(), kd) / math.sqrt(hd)
    keep = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    s = torch.where(keep, s, -1e300)
    lse = torch.logsumexp(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), vd)
    return out, lse


def fwd_readings(torch, FA, build, cs, forms, q, k, v, timed):
    """Each form's out and lse, and the plain version's, against float64;
    with ``timed`` each form's ms a call."""
    want_out, want_lse = fwd64(torch, q, k, v)
    got = {f: fwd_call(torch, build, fn, q, k, v) for f, fn in forms.items()}
    got["plain"] = FA.flash_attention_plain(q, k, v, return_lse=True)
    rec = {}
    for f, (out, lse) in got.items():
        rec[f"{f}_out_vs_float64"] = rel(out, want_out)
        rec[f"{f}_lse_max_abs_err"] = float(
            (lse.double() - want_lse).abs().max())
    del want_out, want_lse, got
    if timed:
        ms = {f: [] for f in forms}
        for f in ("chained", "per_step", "per_step", "chained"):
            ms[f].append(cs.cuda_ms(lambda: fwd_call(torch, build, forms[f],
                                                     q, k, v), iters=50))
        rec.update({f"{f}_ms": json.dumps(v) for f, v in ms.items()})
    return rec


def rel(a, b) -> float:
    return float((a.double() - b.double()).abs().max()
                 / b.double().abs().max().clamp_min(1e-300))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="dbrx-132b",
                    choices=("qwen3-moe-235b-a22b", "dbrx-132b",
                             "qwen2-vl-72b"))
    ap.add_argument("--forward", action="store_true",
                    help="also the forward kernel's two product forms")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("flash_bwd_precision: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import attention as A
    from repro_torch.models import model as TM
    from repro_torch.models.common import rms_norm
    from repro_torch.train.train_step import batch_to_device

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    forward = {}
    if args.forward:
        forms = fwd_forms(build)
        g = torch.Generator(device=card).manual_seed(0)
        for name, B, S, H, KV, hd in FWD_CASES:
            q, k, v = (torch.randn((B, S, h, hd), generator=g, device=card)
                       for h in (H, KV, KV))
            forward[name] = fwd_readings(torch, FA, build, cs, forms,
                                         q, k, v, timed=True)
            print(json.dumps({"forward": name, "shape": [B, S, H, KV, hd],
                              **forward[name]}), flush=True)
            del q, k, v
        torch.cuda.empty_cache()
    tag, arch, experts = next(
        f for f in cs.TRAIN_FAMILIES if f[1] == args.arch)
    cfg = cs.train_cut(get_config(arch), experts)
    model, opt, _ = cs.train_and_check(
        torch, card, f"train_{tag}", cfg, cs.TRAIN_SCAN_STEPS, {}, {})
    del opt
    gc.collect()   # the train loop's closures hold the state in a cycle
    torch.cuda.empty_cache()
    batch = cs.first_rows(cs.launcher_batch(cfg, cs.TRAIN_SCAN_STEPS),
                          cs.TRAIN_B // cs.TRAIN_ACCUM)
    wide = cs.widened(torch, model, cfg, card)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    wide.requires_grad_(True)
    tb = batch_to_device(batch, card)
    kept = []
    real = FA.flash_attention_bwd

    def keep(q, k, v, out, dout, lse, **kw):
        if not kept:
            kept.append((q, k, v, out, dout, lse))
        return real(q, k, v, out, dout, lse, **kw)

    FA.flash_attention_bwd = keep
    try:
        loss, _ = TM.train_loss(wide, tb, remat=True)
        torch.autograd.grad(loss, list(wide.parameters()))
    finally:
        FA.flash_attention_bwd = real
    q, k, v, out, dout, lse = kept[0]
    layer = wide.layers[0]
    with torch.no_grad():
        x = (tb["embeds"] if cfg.embed_inputs
             else torch.nn.functional.embedding(tb["tokens"], wide.embed))
        h = rms_norm(x, layer.ln1, cfg.norm_eps)
        got = {"kernel": FA.flash_attention_bwd(q, k, v, out, dout, lse),
               "plain": FA.flash_attention_bwd_plain(q, k, v, out, dout)}
        exact, ds = bwd64(torch, q, k, v, out, dout)
        # dk = ds^T q with each operand as the kernel's 3xTF32 takes it
        # (hi + lo; the product's own lo lo term and the tensor cores'
        # adds left out), or as float32: which operand's rounding costs
        G = q.shape[2] // k.shape[2]
        ds32 = ds.float()
        dk_ops = {
            "f32_operands": dk_from(torch, ds32.double(),
                                    q.double(), G),
            "ds_3xtf32": dk_from(torch, split3x(torch, ds32),
                                 q.double(), G),
            "q_3xtf32": dk_from(torch, ds32.double(),
                                split3x(torch, q), G),
            "both_3xtf32": dk_from(torch, split3x(torch, ds32),
                                   split3x(torch, q), G)}
        del ds, ds32
        theta = layer.spec.rope_theta
        wk = {n: wk_grad(torch, A, h, g[1], theta) for n, g in got.items()}
        wk_exact = wk_grad(torch, A, h, exact[1], theta)
    rec = {"arch": arch, "shape": list(q.shape), "kv_heads": k.shape[2],
           "mrope_positions": "launcher" if cfg.mrope_sections else None}
    for n, g in got.items():
        for part, a, b in zip(("dq", "dk", "dv"), g, exact):
            rec[f"{n}_{part}_vs_float64"] = rel(a, b)
        rec[f"{n}_wk_grad_vs_float64"] = rel(wk[n], wk_exact)
    rec["kernel_vs_plain_wk_grad"] = rel(wk["kernel"], wk["plain"])
    for n, d in dk_ops.items():
        rec[f"dk_{n}_vs_float64"] = rel(d, exact[1])
        rec[f"dk_{n}_wk_grad_vs_float64"] = rel(
            wk_grad(torch, A, h, d, theta), wk_exact)
    print(json.dumps(rec), flush=True)
    if args.forward:
        del got, exact, wk, wk_exact, dk_ops
        torch.cuda.empty_cache()
        forward[f"{arch}_layer0"] = fwd_readings(
            torch, FA, build, cs, forms, q, k, v, timed=False)
        print(json.dumps({"forward": f"{arch}_layer0",
                          **forward[f"{arch}_layer0"]}), flush=True)
        rec["forward"] = forward
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": smi, **rec}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
