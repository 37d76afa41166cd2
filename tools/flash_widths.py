"""Build the three flash kernels and hold them against the plain version
at every shape ``chip_smoke.py`` times them at, on the card, in ~1-2 min.

Prints ptxas's registers, shared memory and spills for each head width of
``flash_sm90_kernel`` (bf16, wgmma + TMA) and ``flash_f32_kernel``
(float32, 3xTF32 on mma.sync), their HGMMA and HMMA counts, then
``chip_smoke.py``'s ``flash_kernel`` and ``flash_widths`` phases (kernel,
plain version, SDPA and the SIMT kernel ``flash_attention.cu`` on the
same inputs; CUDA events; the bound's three terms), and the card's name
and power limit.

Two ways to time other builds beside this tree's routed kernels, on the
same inputs at every shape of those phases, in the order other, this,
this, other (``[flash_ab]`` lines, each build held to the plain version
first):

* ``--parent DIR``: the sources of an earlier tree (an unpacked ``git
  archive`` under the ignored ``_checkout/``), each shape on the kernel
  that tree routes it to: bf16 on its wgmma kernel where that takes the
  width, else on its SIMT kernel; float32 on its 3xTF32 kernel where it
  has one, else on its SIMT kernel;
* ``--variants a,b``: copies of this tree's ``flash_attention_sm90.cu``
  with one of ``VARIANTS``' patches (each keeps the results right), built
  under the ignored build directory, with their ptxas numbers; bf16
  shapes only.

    python3 tools/flash_widths.py [--parent _checkout/parent]
        [--variants no_pipeline]
        [--out flash_widths.json]
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the consumers' KV loop as the source has it: the next tile's S issued
# before this tile's P V (from the item's first S to its last P V)
PIPELINE_BEGIN = "      turn_begin();\n      issue_s(0);\n"
PIPELINE_END = "      release_v(it.n_tiles - 1);\n"
NO_PIPELINE = """      for (int n = 0; n < it.n_tiles; ++n) {
        turn_begin();
        issue_s(n);
        turn_end();
        wgmma_wait<0>();
        fence_regs<kBN / 2>(sc);
        release_k(n);
        softmax(n);
        rescale_and_pack();
        if (n + 1 == it.n_tiles && lead) mbar_arrive(bar_q_empty);
        turn_begin();
        issue_pv(n);
        turn_end();
        wgmma_wait<0>();
        fence_regs<TW / 2>(acc);
        release_v(n);
      }
"""


def _no_pipeline(src: str) -> str:
    """S, softmax, then P V, each waited for, tile after tile."""
    a = src.index(PIPELINE_BEGIN)
    b = src.index(PIPELINE_END) + len(PIPELINE_END)
    return src[:a] + NO_PIPELINE + src[b:]


VARIANTS = {"no_pipeline": _no_pipeline}


LIBS = ("flash_attention_sm90", "flash_attention_f32_sm90",
        "flash_attention")
KERNELS = {"flash_attention_sm90": "flash_sm90_kernel",
           "flash_attention_f32_sm90": "flash_f32_kernel"}


def instantiations(CS, build, tag=None):
    """ptxas's numbers per head width of each tensor-core flash kernel of
    this tree (``tag`` None) or of another source directory's build."""
    out = {}
    for lib, fn in KERNELS.items():
        log = build.build_logs.get(lib if tag is None else f"{tag}/{lib}")
        if log:
            out[lib] = CS.flash_instantiations(log, fn)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", help="write every result to this JSON file")
    ap.add_argument("--parent", help="an earlier tree to time against")
    ap.add_argument("--variants", default="",
                    help=f"comma-separated, of {sorted(VARIANTS)}")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("flash_widths: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
    import chip_smoke as CS
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as FA

    libs = build.build(list(LIBS))
    inst = instantiations(CS, build)
    CS.say("build", instantiations=json.dumps(inst),
           hgmma=CS.sass_count(libs["flash_attention_sm90"], "HGMMA"),
           f32_hmma=CS.sass_count(libs["flash_attention_f32_sm90"], "HMMA"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = torch.device("cuda")
    out = {"build": inst,
           "flash_kernel": CS.phase_flash_kernel(torch, FA, build, card),
           "flash_widths": CS.phase_flash_widths(torch, FA, build, card)}
    for phase in ("flash_kernel", "flash_widths"):
        for name, nums in out[phase].items():
            CS.say(phase, case=name, **nums)
    others = {}
    if args.parent:
        others["parent"] = Path(args.parent) / "src" / "repro_torch" / \
            "kernels" / "csrc"
    src = (build.CSRC / "flash_attention_sm90.cu").read_text()
    for name in filter(None, args.variants.split(",")):
        d = build.BUILD_DIR / "variants" / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "flash_attention_sm90.cu").write_text(VARIANTS[name](src))
        others[name] = d
    for tag, csrc in others.items():
        names = [n for n in LIBS if (csrc / f"{n}.cu").exists()]
        paths = build.build(names, csrc)
        CS.say("build", other=tag,
               instantiations=json.dumps(instantiations(CS, build,
                                                        csrc.name)))
        out[f"flash_ab_{tag}"] = other_ab(torch, CS, build, FA, card, paths,
                                          csrc)
        for name, nums in out[f"flash_ab_{tag}"].items():
            CS.say("flash_ab", other=tag, case=name, **nums)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(smi)
    out["card"] = smi
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


def _entry(path, ints, pointers=4):
    fn = getattr(ctypes.CDLL(str(path)), f"{Path(path).name.split('-')[0]}"
                 "_launch")
    fn.argtypes = [ctypes.c_void_p] * pointers + [ctypes.c_int] * ints + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _takes_lse(csrc, lib):
    """Whether the tree's forward entry takes the log-sum-exp pointer after
    ``o`` (every tensor-core entry since the backward kernels read it)."""
    return "void* lse" in (Path(csrc) / f"{lib}.cu").read_text()


def other_ab(torch, CS, build, FA, card, paths, csrc):
    """Another tree's flash kernels (``paths``: library by name, built from
    ``csrc``) against this tree's routed kernel, causal, at each shape of
    ``flash_kernel`` and ``flash_widths``: the other side is the first of
    its kernels that takes the shape (a tensor-core entry returns -1 for a
    width it does not take), the SIMT kernel with its dtype code last; a
    shape none takes is skipped.  An entry that takes the log-sum-exp
    pointer is handed null."""
    g = torch.Generator(device=card).manual_seed(4)
    out = {}
    for name, B, S, H, KV, hd, dt, window, *rest in (*CS.FLASH_CASES,
                                                     *CS.WIDTH_CASES):
        dtype = getattr(torch, dt)
        iters = rest[0] if rest else 200
        q, k, v = (torch.randn((B, S, h, hd), generator=g, device=card)
                   .to(dtype) for h in (H, KV, KV))
        want = FA.flash_attention_plain(q, k, v, sliding_window=window)
        dev, stream = build.device_and_stream(q)
        head = (B, S, H, KV, hd, 1, window)
        mine = FA._entry(FA.route(dtype, hd))
        tried = [(lib, _entry(paths[lib], 8, 4 + lse), (None,) * lse, ())
                 for lib in ("flash_attention_sm90" if dt == "bfloat16"
                             else "flash_attention_f32_sm90",)
                 if lib in paths for lse in (int(_takes_lse(csrc, lib)),)]
        if "flash_attention" in paths:
            tried.append(("flash_attention", _entry(
                paths["flash_attention"], 9), (), (FA._DTYPES[dtype],)))

        def call(fn, lse, extra):
            o = torch.empty_like(q)

            def run():
                return fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          o.data_ptr(), *lse, *head, *extra, dev, stream)
            return o, run

        runs = {}
        for tag, lib, fn, lse, extra in (
                *(("other", *t) for t in tried),
                ("this", FA.route(dtype, hd)[0], mine, (None,), ())):
            if tag in runs:
                continue
            o, run = call(fn, lse, extra)
            err = run()
            if err == -1:
                continue           # that kernel does not take hd
            if err:
                raise RuntimeError(f"{tag} {lib} launch failed: {err}")
            torch.cuda.synchronize()
            CS._close(torch, o, want, *CS.KERNEL_TOL[dt],
                      f"{tag} {lib} {name}")
            runs[tag] = (lib, run)
        if len(runs) < 2:
            continue
        ms = {}
        for tag in ("other", "this", "this", "other"):
            ms.setdefault(tag, []).append(CS.cuda_ms(
                runs[tag][1], iters=iters, warmup=max(2, iters // 10)))
        out[name] = dict(shape=f"B{B} S{S} H{H}/{KV} hd{hd} {dt} "
                         f"window{window}",
                         other_kernel=runs["other"][0],
                         this_kernel=runs["this"][0],
                         other_ms=json.dumps(ms["other"]),
                         this_ms=json.dumps(ms["this"]),
                         ratio=min(ms["this"]) / min(ms["other"]))
    return out


if __name__ == "__main__":
    sys.exit(main())
