"""Build the kernels one architecture trains through and run
``chip_smoke.py``'s training phases for it on the card, with the
backward kernels' ptxas numbers and the card's name and power limit.

``--arch smollm-135m`` (the default, ~1-2 min): ``flash_bwd_kernel`` (the
backward flash kernels against their plain version at smollm-135m's,
hubert-xlarge's and ``main_hd128``'s shapes in both dtypes, and a windowed
case; times beside the plain version, SDPA's backward (its device time
from a profiler trace too) and the SIMT kernel, and bounds) and
``train_smollm`` (20 full-size smollm-135m steps through the launcher's
loop, launch counts, loss fall, a profiled step, a float32 copy's
kernel-path gradients against the plain path's).

``--arch zamba2-1.2b``: ``ssd_bwd_kernel`` (the SSD backward kernel
against ``ssd_bwd_plain`` at zamba2-1.2b's train microbatch in bf16 and
float32, a ragged T and the smoke width) and ``train_zamba2`` (the full
model through the launcher's loop).  ``--arch rwkv6-7b``:
``wkv_bwd_kernel`` and ``train_rwkv6`` (full width, 4 of 32 layers).
``--arch qwen3-moe-235b-a22b`` (or ``dbrx-132b``, ``qwen2-vl-72b``):
``flash_bwd_kernel`` at that family's attention alone (GQA group 16, 6
or 8, in bf16 and float32) and ``train_qwen3moe`` (``train_dbrx``,
``train_qwen2vl``: full width on the first layer, the MoE on 64 / 8
experts, as ``chip_smoke.TRAIN_FAMILIES`` says).  Several ``--arch``
run in turn; ``--arch all`` runs them all.

    python3 tools/train_phases.py [--arch A [A ...]] [--out FILE.json]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("smollm-135m", "zamba2-1.2b", "rwkv6-7b", "qwen3-moe-235b-a22b",
         "dbrx-132b", "qwen2-vl-72b")
FLASH = ["flash_attention_bwd_sm90", "flash_attention_bwd_f32_sm90",
         "flash_attention_sm90", "flash_attention_f32_sm90"]
# the libraries each architecture's phases build
LIBS = {"smollm-135m": ["flash_attention_bwd_sm90",
                        "flash_attention_bwd_f32_sm90",
                        "flash_attention_bwd", "flash_attention_sm90",
                        "flash_attention_f32_sm90"],
        "zamba2-1.2b": ["ssd_bwd_sm90", "ssd_sm90", "ssd",
                        "flash_attention_bwd_sm90",
                        "flash_attention_bwd_f32_sm90",
                        "flash_attention_sm90", "flash_attention_f32_sm90"],
        "rwkv6-7b": ["wkv_bwd", "wkv"],
        "qwen3-moe-235b-a22b": FLASH, "dbrx-132b": FLASH,
        "qwen2-vl-72b": FLASH}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", nargs="+", default=["smollm-135m"],
                    choices=(*ARCHS, "all"))
    ap.add_argument("--out", default=None, help="write the numbers here")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("train_phases: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import numpy as np

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import rwkv_wkv as WKV
    from repro_torch.kernels import ssd as SSD
    from repro_torch.models import rwkv as R

    archs = ARCHS if "all" in args.arch else args.arch
    libs = sorted({lib for a in archs for lib in LIBS[a]})
    build.build(libs)
    for lib in libs:
        if "bwd" in lib:   # the backward kernels' ptxas numbers
            for name, nums in cs.ptxas_summary(
                    build.build_logs.get(lib, "")).items():
                cs.say("build", lib=lib, entry=name[-60:], **nums)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = torch.device("cuda")
    phases = {
        "smollm-135m": [
            # the cases the SIMT kernel is timed at (not the MoE and
            # qwen2-vl ones)
            ("flash_bwd_kernel", lambda: cs.phase_flash_bwd_kernel(
                torch, FA, build, card, library_device=True,
                cases=[c[0] for c in cs.BWD_CASES if c[-1]])),
            ("train_smollm", lambda: cs.phase_train_smollm(torch, card, FA))],
        "zamba2-1.2b": [
            ("ssd_bwd_kernel", lambda: cs.phase_ssd_bwd_kernel(
                torch, SSD, card)),
            ("train_zamba2", lambda: cs.phase_train_zamba2(
                torch, card, FA, SSD))],
        "rwkv6-7b": [
            ("wkv_bwd_kernel", lambda: cs.phase_wkv_bwd_kernel(
                torch, R, WKV, card)),
            ("train_rwkv6", lambda: cs.phase_train_rwkv6(
                torch, card, FA, WKV))]}
    for tag, arch, experts in cs.TRAIN_FAMILIES:
        phases[arch] = [
            ("flash_bwd_kernel", lambda tag=tag: cs.phase_flash_bwd_kernel(
                torch, FA, build, card, cases=(tag, f"{tag}_float32"))),
            (f"train_{tag}", lambda tag=tag, arch=arch, experts=experts:
             cs.phase_train_family(torch, np, card, FA, f"train_{tag}",
                                   cs.train_cut(get_config(arch), experts)))]
    out = {}
    for a in archs:
        for name, run in phases[a]:
            key = name if name not in out else f"{name}_{a}"
            out[key] = run()
            if name.endswith("_kernel"):
                for case, nums in out[key].items():
                    cs.say(name, case=case, **nums)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(smi)
    out["card"] = smi
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
