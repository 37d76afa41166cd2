#!/usr/bin/env python3
"""The scan backward kernels of this tree against an earlier tree's, on one card.

Run from the root of a checkout, on a machine with a CUDA card::

    python3 tools/scan_bwd_ab.py --parent DIR [--train [ARCH ...]]
        [--out FILE]

``DIR`` is an unpacked checkout of an earlier commit (``git archive``)
with ``csrc/ssd_bwd_sm90.cu`` and ``csrc/wkv_bwd.cu``.  Their C entries
(``ssd_bwd_launch``, ``wkv_bwd_launch``) are read from those sources: an
SSD entry with a ``heads`` parameter takes dB / dC partials of each group
of heads (B, T, ceil(H / heads), N) with this tree's ``ssd._bwd_heads``,
one without takes them per head (B, T, H, N).  Steps:

1. both trees' libraries built with this tree's ``nvcc`` flags (a source
   the same as this tree's is built once); ptxas's registers and spills of
   each entry;
2. at zamba2-1.2b's train microbatch (``chip_smoke.SSD_BWD_CASES``
   ``train`` and ``train_float32``) and rwkv6-7b's (``WKV_BWD_CASES``
   ``train_clamped`` and ``train_real``), on the inputs ``chip_smoke.py``
   makes: each kernel against ``*_bwd_plain`` (each gradient within
   ``chip_smoke.SCAN_BWD_TOL`` of its largest value), then each call's
   device time from a CUDA graph (``chip_smoke.graph_ms``) in the order
   earlier, this, this, earlier;
3. with ``--train``, ``tools/train_phases.py --arch A`` of each tree in a
   child process, for each architecture named (zamba2-1.2b and rwkv6-7b
   if none is; any of ``train_phases.ARCHS``), in the order earlier, this:
   the train phase's median step, its profiled step's device time, the
   scan backward's share of it and the peak memory; then whether the two
   trees' losses are the same, bit for bit where both trees print them
   unrounded (``chip_smoke.train_and_check`` does since it moved the
   step's AdamW and compression in place), else to the 4 places an
   earlier tree printed.

Prints the card's name and power limit and one JSON line per step, and
with ``--out FILE`` also writes all of it to FILE as one JSON list.
Exits non-zero on any failed check.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import threading
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIBS = ("ssd_bwd_sm90", "wkv_bwd")
RECORDS: list[dict] = []


def _out(rec: dict) -> None:
    RECORDS.append(rec)
    print(json.dumps(rec), flush=True)


def _entry(build, csrc, lib, name):
    """The C entry ``name`` of ``<csrc>/<lib>.cu``, loaded, with argtypes
    from its declaration (a pointer as c_void_p, an int as c_int), and its
    parameters' names."""
    src = (csrc / f"{lib}.cu").read_text()
    m = re.search(r'extern "C" int ' + name + r"\((.*?)\)\s*\{", src, re.S)
    if m is None:
        raise RuntimeError(f"{csrc}/{lib}.cu declares no {name}")
    params = [p.strip() for p in m.group(1).split(",")]
    fn = getattr(build.load(lib, csrc), name)
    fn.argtypes = [ctypes.c_void_p if "*" in p else ctypes.c_int
                   for p in params]
    fn.restype = ctypes.c_int
    return fn, [re.split(r"[\s*]+", p)[-1] for p in params]


def _earlier_ssd(torch, build, SSD, csrc):
    """The earlier tree's SSD backward as a function of this tree's
    arguments, its scratch laid out as its entry takes it."""
    fn, names = _entry(build, csrc, "ssd_bwd_sm90", "ssd_bwd_launch")
    grouped = "heads" in names

    def call(x, dt, A, Bm, Cm, dy, ds):
        Bsz, T, H, P = x.shape
        N = Bm.shape[-1]
        nc = -(-T // SSD.CHUNK)
        dev, stream = build.device_and_stream(x)
        heads = SSD._bwd_heads(Bsz, nc, H, torch.cuda.get_device_properties(
            dev).multi_processor_count) if grouped else 1
        f32 = dict(dtype=torch.float32, device=x.device)
        outs = (torch.empty_like(x), torch.empty_like(dt),
                torch.empty_like(A), torch.empty_like(Bm),
                torch.empty_like(Cm))
        states = torch.empty((2, Bsz, nc, H, P, N), **f32)
        parts = torch.empty((2, Bsz, T, -(-H // heads), N), **f32)
        small = torch.empty((2, Bsz * nc * H), **f32)
        err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                 Cm.data_ptr(), dy.data_ptr(),
                 0 if ds is None else ds.data_ptr(), *(
                     o.data_ptr() for o in outs), states[0].data_ptr(),
                 states[1].data_ptr(), parts[0].data_ptr(),
                 parts[1].data_ptr(), small[0].data_ptr(),
                 small[1].data_ptr(), Bsz, T, H, P, N,
                 *((heads,) if grouped else ()), SSD._DTYPES[x.dtype], dev,
                 stream)
        if err != 0:
            raise RuntimeError(f"earlier ssd_bwd launch failed: {err}")
        return outs
    return call


def _earlier_wkv(torch, build, csrc):
    """The earlier tree's WKV backward (this tree's entry and scratch)."""
    fn, _ = _entry(build, csrc, "wkv_bwd", "wkv_bwd_launch")

    def call(r, k, v, w, u, H, Lc, dy, ds):
        B, T, HP = r.shape
        P = HP // H
        nc = T // Lc
        f32 = dict(dtype=torch.float32, device=r.device)
        outs = tuple(torch.empty_like(r) for _ in range(4)) + (
            torch.empty_like(u),)
        states = torch.empty((2, B, nc, H, P, P), **f32)
        small = torch.empty((2, B * nc * H * P), **f32)
        dev, stream = build.device_and_stream(r)
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                 u.data_ptr(), dy.data_ptr(),
                 0 if ds is None else ds.data_ptr(), *(
                     o.data_ptr() for o in outs), states[0].data_ptr(),
                 states[1].data_ptr(), small.data_ptr(), B, T, H, P, Lc,
                 dev, stream)
        if err != 0:
            raise RuntimeError(f"earlier wkv_bwd launch failed: {err}")
        return outs
    return call


def _compare(torch, cs, kernel, name, dtype, got, want, grads):
    """Each gradient within SCAN_BWD_TOL of its largest value."""
    out = {}
    for part, a, b in zip(grads, got, want):
        if not torch.isfinite(a).all():
            raise AssertionError(f"{kernel} {name} {part}: not finite")
        rel = float((a.float() - b.float()).abs().max()) / max(
            float(b.float().abs().max()), 1e-30)
        if rel > cs.SCAN_BWD_TOL[dtype]:
            raise AssertionError(f"{kernel} {name} {part}: {rel}")
        out[part] = rel
    return max(out.values())


def _kernels(torch, cs, build, SSD, WKV, csrc) -> None:
    earlier = {"ssd_bwd": _earlier_ssd(torch, build, SSD, csrc),
               "wkv_bwd": _earlier_wkv(torch, build, csrc)}
    card = torch.device("cuda")
    g = torch.Generator(device=card).manual_seed(11)
    for name, B, T, H, P, N, dt_name, ws in cs.SSD_BWD_CASES:
        if name not in ("train", "train_float32"):
            continue
        dtype = getattr(torch, dt_name)
        x = torch.randn((B, T, H, P), generator=g, device=card).to(dtype)
        dt = torch.rand((B, T, H), generator=g, device=card) * 0.19 + 0.01
        A = -torch.linspace(1.0, 16.0, H, device=card)
        Bm, Cm = (torch.randn((B, T, N), generator=g, device=card).to(dtype)
                  for _ in range(2))
        dy = torch.randn((B, T, H, P), generator=g, device=card).to(dtype)
        ds = (torch.randn((B, H, P, N), generator=g, device=card)
              if ws else None)
        args = (x, dt, A, Bm, Cm, dy, ds)
        _time(torch, cs, "ssd_bwd", name, dt_name, args,
              earlier["ssd_bwd"], SSD.ssd_bwd, SSD.ssd_bwd_plain,
              cs.SSD_GRADS)
    g = torch.Generator(device=card).manual_seed(12)
    for name, B, T, H, P, regime, ws in cs.WKV_BWD_CASES:
        if name not in ("train_clamped", "train_real"):
            continue
        shape = (B, T, H * P)
        r, k, v, dy = (torch.randn(shape, generator=g, device=card)
                       for _ in range(4))
        w = (torch.full(shape, cs.CLAMPED_W, device=card)
             if regime == "clamped" else
             torch.rand(shape, generator=g, device=card) * 0.149 + 0.85)
        u = torch.randn((H, P), generator=g, device=card) * 0.1
        ds = (torch.randn((B, H, P, P), generator=g, device=card)
              if ws else None)
        args = (r, k, v, w, u, H, 64, dy, ds)
        _time(torch, cs, "wkv_bwd", name, "float32", args,
              earlier["wkv_bwd"], WKV.wkv_bwd, WKV.wkv_bwd_plain,
              cs.WKV_GRADS)


def _time(torch, cs, kernel, name, dtype, args, earlier, this, plain,
          grads) -> None:
    want = plain(*args)
    errs = {"earlier": _compare(torch, cs, kernel, name, dtype,
                                earlier(*args), want, grads),
            "this": _compare(torch, cs, kernel, name, dtype, this(*args),
                             want, grads)}
    del want
    ms = {}
    for tag, fn in (("earlier", earlier), ("this", this),
                    ("this2", this), ("earlier2", earlier)):
        ms[tag] = cs.graph_ms(torch, lambda: fn(*args), calls=5, replays=5)
    _out({"step": "kernel", "kernel": kernel, "case": name,
          "earlier_ms": min(ms["earlier"], ms["earlier2"]),
          "this_ms": min(ms["this"], ms["this2"]), "runs_ms": ms,
          "earlier_max_rel_err": errs["earlier"],
          "this_max_rel_err": errs["this"],
          "earlier_passes_ms": _passes(torch, lambda: earlier(*args)),
          "this_passes_ms": _passes(torch, lambda: this(*args))})


def _passes(torch, fn, calls=3):
    """Device ms a call of each of fn's kernels (``torch.profiler``)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            m = re.search(r"(\w+_kernel)", e.key)
            name = m.group(1) if m else e.key[:40]
            out[name] = (out.get(name, 0.0)
                         + e.self_device_time_total / calls / 1e3)
    return out


def _train(parent: str, out_dir: str, archs) -> None:
    """train_phases.py of each tree in a child process (earlier, this),
    and whether the two trees' losses agree."""
    for arch in archs:
        losses = {}
        for tag, root in (("earlier", parent), ("this", ROOT)):
            path = os.path.join(out_dir, f"scan_ab_{tag}_{arch}.json")
            proc = subprocess.run(
                [sys.executable, os.path.join(root, "tools",
                                              "train_phases.py"),
                 "--arch", arch, "--out", path], cwd=root,
                capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"{tag} train_phases {arch}: exit "
                                   f"{proc.returncode}\n{proc.stdout[-3000:]}"
                                   f"\n{proc.stderr[-3000:]}")
            with open(path) as f:
                phases = json.load(f)
            train = next(v for k, v in phases.items()
                         if k.startswith("train_"))
            losses[tag] = json.loads(train["losses"])
            _out({"step": "train", "arch": arch, "tree": tag, **{
                k: train[k] for k in (
                    "median_step_ms", "min_step_ms", "tokens_per_s",
                    "profiled_step_ms", "device_us", "device_busy_share",
                    "scan_bwd_device_share", "scan_fwd_device_share",
                    "flash_device_share", "scan_bwd_launches",
                    "max_memory_allocated") if k in train}})
        rounded = all(x == round(x, 4) for x in losses["earlier"])
        mine = [round(x, 4) for x in losses["this"]] if rounded else \
            losses["this"]
        _out({"step": "train_losses", "arch": arch,
              "compared_at": "4 places" if rounded else "bits",
              "same_losses": mine == losses["earlier"],
              "losses": losses["this"]})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True,
                    help="unpacked checkout of the earlier commit")
    ap.add_argument("--train", nargs="*", default=None, metavar="ARCH",
                    help="also each tree's train phases (child processes)")
    ap.add_argument("--out", default=None, help="write the records here")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("scan_bwd_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import rwkv_wkv as WKV
    from repro_torch.kernels import ssd as SSD

    parent = os.path.abspath(args.parent)
    csrc = Path(parent) / "src" / "repro_torch" / "kernels" / "csrc"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    _out({"step": "card", "nvidia_smi": smi})
    # a library whose source and headers are this tree's has this tree's
    # build (the same file): built once
    own = [lib for lib in LIBS
           if build._target(lib, csrc) != build._target(lib, build.CSRC)]
    other = threading.Thread(target=build.build, args=(own, csrc))
    other.start()
    try:
        build.build(list(LIBS))
    finally:
        other.join()
    for lib in LIBS:
        for tag, key in (("earlier", f"{csrc.name}/{lib}"), ("this", lib)):
            for entry, nums in cs.ptxas_summary(
                    build.build_logs.get(key, "")).items():
                _out({"step": "build", "tree": tag, "lib": lib,
                      "entry": entry[-60:], **nums})
    _kernels(torch, cs, build, SSD, WKV, csrc)
    if args.train is not None:
        out_dir = os.path.dirname(os.path.abspath(args.out or "x"))
        _train(parent, out_dir, args.train or ("zamba2-1.2b", "rwkv6-7b"))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(RECORDS, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
