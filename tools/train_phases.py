"""Build the backward flash kernels (bf16 wgmma, float32 3xTF32, and the
SIMT one they replaced) and the forward ones, and run ``chip_smoke.py``'s
two training phases on the card, in ~1-2 min: ``flash_bwd_kernel`` (the
kernels against their plain version at smollm-135m's, hubert-xlarge's and
``main_hd128``'s shapes in both dtypes, and a windowed case; times beside
the plain version, SDPA's backward (its device time from a profiler
trace too) and the SIMT kernel, and bounds) and
``train_smollm`` (20 full-size smollm-135m steps through the launcher's
loop, launch counts, loss fall, a profiled step, a float32 copy's
kernel-path gradients against the plain path's).  Prints ptxas's numbers
for the backward kernels' entries and the card's name and power limit.

    python3 tools/train_phases.py [--out chiprun_out/train_phases.json]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="write the numbers here")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("train_phases: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as FA

    bwd = ["flash_attention_bwd_sm90", "flash_attention_bwd_f32_sm90",
           "flash_attention_bwd"]
    build.build(["flash_attention_sm90", "flash_attention_f32_sm90", *bwd])
    for lib in bwd:
        for name, nums in cs.ptxas_summary(
                build.build_logs.get(lib, "")).items():
            cs.say("build", lib=lib, entry=name[-60:], **nums)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = torch.device("cuda")
    out = {"flash_bwd_kernel": cs.phase_flash_bwd_kernel(
        torch, FA, build, card, library_device=True)}
    for name, nums in out["flash_bwd_kernel"].items():
        cs.say("flash_bwd_kernel", case=name, **nums)
    out["train_smollm"] = cs.phase_train_smollm(torch, card, FA)
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
