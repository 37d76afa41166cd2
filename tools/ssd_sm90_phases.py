#!/usr/bin/env python3
"""Where a block of the bf16 SSD kernel (``csrc/ssd_sm90.cu``) spends its
life, on the card.

Builds copies of the kernel's source under the ignored build directory
with ``SSD_PHASES`` defined, so that thread 0 of each block writes the
global timer at each mark ``MARKS`` names below, one copy for each G
(heads a block: the kernel's ``kGroup``, patched) and each ``--variants``
entry (timing-only source patches: their results are wrong and only the
marks are read).  Runs each at zamba2-1.2b's prefill shape (B 4, T 1024,
H 64, P 64, N 64, bf16) after a warm-up, holds the unpatched kernel's y
against ``ssd_plain``, and prints one JSON line a copy: medians of each
phase over the blocks, the hop along a chain (a chunk's state written to
the next chunk's), the hand-over (the state written to its reader seeing
it, where the reader waited), the blocks in flight at once, and the span
of the marks.  The marks cost a store each; the unmarked kernel's times
are ``chip_smoke.py``'s.

Run from the root of a checkout on a machine with a card:
``python3 tools/ssd_sm90_phases.py [--groups 1,2,4] [--variants as_is]
[--out ssd_phases.json]``.
"""
import argparse
import json
import os
import shutil
import statistics
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the kernel's MARK(k), in order: what thread 0 of a block has seen by then
MARKS = ["start",        # its ticket taken
         "bc",           # B, C and dt landed
         "x",            # x landed, C B^T, cum, dec formed
         "got",          # its first S_{c-1} values from its twin (c > 0)
         "own",          # its part of S_c written
         "all",          # every warp's, and S_{c-1} staged
         "y_inter",      # y_inter formed
         "end"]          # y stored
SLOTS = 8
GROUP_LINE = "constexpr int kGroup = 2;"   # patched to each --groups G
# timing-only variants (their results are wrong; only the marks are read):
# each replaces one piece of the chain section's source
VARIANTS = {
    "as_is": [],
    "no_bulk_loads": [("copy16(Cs + t * ldC + e, Cm + off, ok);", ""),
                      ("copy16(Bs + t * ldC + e, Bm + off, ok);", ""),
                      ("copy16(Xs + t * ldX + e * 8, x + off, ok);", "")],
    "spin": [("__nanosleep(32);", "")],
    "no_y_stores": [("*reinterpret_cast<uint4*>(y + ((row0 + t) * H + h0) * "
                     "P + e * 8) =", "(void)")],
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the JSON lines here")
    ap.add_argument("--groups", default="1,2,4")
    ap.add_argument("--variants", default="as_is",
                    help=f"comma-separated, of {sorted(VARIANTS)}")
    opts = ap.parse_args()
    import ctypes

    import torch

    if not torch.cuda.is_available():
        print("ssd_sm90_phases: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels import ssd as SSD

    libs = {}
    for variant in opts.variants.split(","):
        for group in (int(v) for v in opts.groups.split(",")):
            text = ("#define SSD_PHASES\n"
                    + (build.CSRC / "ssd_sm90.cu").read_text())
            for a, b in VARIANTS[variant] + [(
                    GROUP_LINE, f"constexpr int kGroup = {group};")]:
                if a not in text:
                    raise ValueError(f"{variant}: {a!r} not in the source")
                text = text.replace(a, b)
            marked = build.BUILD_DIR / "phases" / f"{variant}-g{group}"
            marked.mkdir(parents=True, exist_ok=True)
            (marked / "ssd_sm90.cu").write_text(text)
            libs[variant, group] = build.load("ssd_sm90", marked)

    card = torch.device("cuda")
    g = torch.Generator(device=card).manual_seed(2)
    B, T, H, P, N = 4, 1024, 64, 64, 64
    x = torch.randn((B, T, H, P), generator=g, device=card).bfloat16()
    dt = torch.rand((B, T, H), generator=g, device=card) * 0.19 + 0.01
    A = -torch.linspace(1.0, 16.0, H, device=card)
    Bm = torch.randn((B, T, N), generator=g, device=card).bfloat16()
    Cm = torch.randn((B, T, N), generator=g, device=card).bfloat16()
    nc = -(-T // SSD.CHUNK)
    lines = []
    for (variant, group), lib in libs.items():
        launch = lib.ssd_sm90_launch
        launch.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        launch.restype = ctypes.c_int
        lib.ssd_sm90_set_marks.argtypes = [ctypes.c_void_p]
        groups = -(-H // group)
        chains = B * groups
        marks = torch.zeros((chains * nc, SLOTS), dtype=torch.int64,
                            device=card)
        if lib.ssd_sm90_set_marks(marks.data_ptr()):
            raise RuntimeError("ssd_sm90_set_marks failed")

        def run():
            y = torch.empty_like(x)
            state = torch.zeros((B, H, P, N), device=card)
            sync = torch.zeros(1 + B * H, dtype=torch.int32, device=card)
            dev, stream = build.device_and_stream(x)
            err = launch(x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                         Bm.data_ptr(), Cm.data_ptr(), y.data_ptr(),
                         state.data_ptr(), sync.data_ptr(), B, T, H, P, N,
                         dev, stream)
            if err:
                raise RuntimeError(f"marked ssd_sm90 launch failed: {err}")
            return y, state

        for _ in range(5):
            run()
        torch.cuda.synchronize()
        want = SSD.ssd_plain(x, dt, A, Bm, Cm)
        y, state = run()
        torch.cuda.synchronize()
        if variant == "as_is" and not torch.allclose(
                y.float(), want[0].float(), rtol=1e-2, atol=1e-2):
            raise AssertionError("marked kernel disagrees with ssd_plain")
        m = marks.cpu().tolist()   # by ticket: chunk-major
        t0 = min(r[0] for r in m)
        m = [[v - t0 if v else None for v in r] for r in m]

        k = {name: i for i, name in enumerate(MARKS)}

        def med(a, b, first=None):
            vals = [r[k[b]] - r[k[a]] for n, r in enumerate(m)
                    if r[k[a]] is not None and r[k[b]] is not None and
                    (first is None or (n < chains) == first)]
            return statistics.median(vals) / 1e3 if vals else None

        steps, wait_lat = [], []
        for bg in range(chains):
            for c in range(1, nc):
                prev, cur = m[(c - 1) * chains + bg], m[c * chains + bg]
                steps.append(cur[k["own"]] - prev[k["own"]])
                if cur[k["got"]] - cur[k["x"]] > 1000:  # it waited
                    wait_lat.append(cur[k["got"]] - prev[k["own"]])
        events = sorted([(r[0], 1) for r in m] +
                        [(r[k["end"]], -1) for r in m])
        live = peak = 0
        for _, d in events:
            live += d
            peak = max(peak, live)
        nums = dict(
            variant=variant, group=group, blocks=len(m),
            span_us=max(r[k["end"]] for r in m) / 1e3, resident_peak=peak,
            life_us=med("start", "end"),
            life_first_chunk_us=med("start", "end", True),
            bc_dt_load_us=med("start", "bc"), x_load_cb_us=med("bc", "x"),
            products_and_wait_us=med("x", "got", False),
            chain_own_us=med("got", "own", False),
            first_chunk_products_us=med("x", "own", True),
            all_us=med("own", "all"), y_inter_us=med("all", "y_inter", False),
            y_store_us=med("y_inter", "end"),
            hop_us=statistics.median(steps) / 1e3,
            hand_over_us=(statistics.median(wait_lat) / 1e3
                          if wait_lat else None),
            waited_blocks=len(wait_lat))
        line = json.dumps(nums)
        print(line, flush=True)
        lines.append(line)
    print(subprocess_smi(), flush=True)
    if opts.out:
        with open(opts.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    shutil.rmtree(build.BUILD_DIR / "phases", ignore_errors=True)
    return 0


def subprocess_smi():
    import subprocess

    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


if __name__ == "__main__":
    sys.exit(main())
