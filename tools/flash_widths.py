"""Build both flash kernels and hold them against the plain version at
every shape ``chip_smoke.py`` times them at, on the card, in ~1-2 min.

Prints ptxas's registers, shared memory and spills for each head width of
``flash_sm90_kernel``, its HGMMA count, then ``chip_smoke.py``'s
``flash_kernel`` and ``flash_widths`` phases (kernel, plain version, SDPA
and, for a bf16 shape the wgmma kernel takes, the SIMT kernel on the same
inputs; CUDA events), and the card's name and power limit.

Two ways to time another build of ``flash_attention_sm90.cu`` beside this
one, on the same inputs at every bf16 shape of those phases it takes, in
the order other, this, this, other (``[flash_ab]`` lines, each build held
to the plain version first):

* ``--parent DIR``: the source of an earlier tree (an unpacked ``git
  archive`` under the ignored ``_checkout/``);
* ``--variants a,b``: copies of this source with one of ``VARIANTS``'
  patches (each keeps the results right), built under the ignored build
  directory, with their ptxas numbers.

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

    libs = build.build(["flash_attention", "flash_attention_sm90"])
    inst = CS.flash_instantiations(
        build.build_logs.get("flash_attention_sm90", ""))
    CS.say("build", flash_attention_sm90_instantiations=json.dumps(inst),
           hgmma=CS.sass_count(libs["flash_attention_sm90"], "HGMMA"))
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
        lib = build.build(["flash_attention_sm90"], csrc)[
            "flash_attention_sm90"]
        inst = CS.flash_instantiations(
            build.build_logs.get(f"{csrc.name}/flash_attention_sm90", ""))
        CS.say("build", other=tag,
               flash_attention_sm90_instantiations=json.dumps(inst))
        out[f"flash_ab_{tag}"] = other_ab(torch, CS, build, FA, card, lib)
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


def other_ab(torch, CS, build, FA, card, path):
    """Another build of ``flash_attention_sm90`` (the library at ``path``)
    against this one, bf16, causal, at each shape of ``flash_kernel`` and
    ``flash_widths`` whose width the other build takes (its entry returns
    -1 for another)."""
    before = ctypes.CDLL(str(path)).flash_attention_sm90_launch
    before.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [
        ctypes.c_void_p]
    before.restype = ctypes.c_int
    this = FA._entry(FA.SM90)
    cases = [("main", 4, 1024, 32, 32, 64, 0),
             ("main_hd128", 4, 1024, 16, 16, 128, 0),
             ("ragged_bf16", 1, 1000, 9, 3, 64, 100)] + [
        (c[0], *c[1:6], c[7]) for c in CS.WIDTH_CASES if c[6] == "bfloat16"]
    g = torch.Generator(device=card).manual_seed(4)
    out = {}
    for name, B, S, H, KV, hd, window in cases:
        q, k, v = (torch.randn((B, S, h, hd), generator=g, device=card)
                   .to(torch.bfloat16) for h in (H, KV, KV))
        want = FA.flash_attention_plain(q, k, v, sliding_window=window)
        dev, stream = build.device_and_stream(q)

        def call(fn):
            o = torch.empty_like(q)

            def run():
                return fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          o.data_ptr(), B, S, H, KV, hd, 1, window, dev,
                          stream)
            return o, run

        runs = {}
        for tag, fn in (("other", before), ("this", this)):
            o, run = call(fn)
            err = run()
            if err == -1:
                break              # the other build does not take hd
            if err:
                raise RuntimeError(f"{tag} flash launch failed: {err}")
            torch.cuda.synchronize()
            CS._close(torch, o, want, *CS.KERNEL_TOL["bfloat16"],
                      f"{tag} flash {name}")
            runs[tag] = run
        if len(runs) < 2:
            continue
        ms = {}
        for tag in ("other", "this", "this", "other"):
            ms.setdefault(tag, []).append(CS.cuda_ms(runs[tag]))
        out[name] = dict(shape=f"B{B} S{S} H{H}/{KV} hd{hd} window{window}",
                         other_ms=json.dumps(ms["other"]),
                         this_ms=json.dumps(ms["this"]),
                         ratio=min(ms["this"]) / min(ms["other"]))
    return out


if __name__ == "__main__":
    sys.exit(main())
