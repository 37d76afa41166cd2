"""Benchmark harness of the PyTorch port: one module per paper table or
figure, and the substrate benches.  Prints ``name,us_per_call,derived``
rows.  The port's counterpart of ``benchmarks/run.py``.

    PYTHONPATH=src python benchmarks/torch_run.py --device cpu [--full]
    PYTHONPATH=src python benchmarks/torch_run.py --selftest

``--device`` picks where every bench runs (default: the CUDA card;
``--device cpu`` the CPU).  ``--selftest`` imports each bench and checks
that it has a callable ``run``, without running any.
"""
from __future__ import annotations

import argparse
import importlib
import os
import sys
import traceback

# the benches are plain files beside this one: make them importable by
# name whichever directory the harness is started from
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

MODULES = [
    "bench_torch_paper",              # Figs. 6-7 / Table II / Table I
    "bench_torch_schedulers",         # Figs. 13-15
    "bench_torch_control",            # runtime mitigation on / off
    "bench_torch_scheduler_latency",
    "bench_torch_rollout_scale",      # the replay engine's vmap rows
    "bench_torch_metric_pipeline",
]


def rows(mod, fast: bool, device) -> list:
    """The module's rows.  ``bench_torch_metric_pipeline.run(device=,
    full=)`` returns a dict holding them; every other bench follows
    ``run(fast=, device=)`` and returns the rows."""
    if mod.__name__ == "bench_torch_metric_pipeline":
        return mod.run(device=device, full=not fast)["rows"]
    return mod.run(fast=fast, device=device)


def selftest() -> int:
    failures = 0
    for name in MODULES:
        try:
            mod = importlib.import_module(name)
            if not callable(getattr(mod, "run", None)):
                raise TypeError("module has no callable run")
            print(f"{name}: ok")
        except Exception as e:
            failures += 1
            print(f"{name}: FAIL ({e})")
            traceback.print_exc(file=sys.stderr)
    print(f"selftest: {len(MODULES) - failures}/{len(MODULES)} modules ok")
    return 1 if failures else 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--selftest", action="store_true")
    args = ap.parse_args()
    if args.selftest:
        return selftest()
    from repro_torch.device import resolve_device

    device = resolve_device(args.device)
    failures = 0
    print("name,us_per_call,derived")
    for name in MODULES:
        try:
            mod = importlib.import_module(name)
            for row_name, us, derived in rows(mod, not args.full, device):
                print(f"{row_name},{us:.1f},{derived}")
            sys.stdout.flush()
        except Exception:
            failures += 1
            print(f"{name},0,ERROR")
            traceback.print_exc(file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
