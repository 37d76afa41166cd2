"""The PyTorch port's paper pieces: Figs. 6-7 (resource model), Table II
(the five scheduling-latency predictors) and Table I (the motivation
study), as ``name,us_per_call,derived`` rows.

The port's counterpart of ``bench_resource_model``, ``bench_predictors``
and ``bench_motivation``.  ``--device`` picks where the port runs (default:
the CUDA card; ``--device cpu`` runs it on the CPU); ``--full`` generates
Table II's dataset at 700 placements instead of 250.  Times are host
clock around work that ends in a device synchronise, so on the card they
include the device time.

    PYTHONPATH=src python benchmarks/bench_torch_paper.py --device cpu
"""
from __future__ import annotations

import argparse
import time

from repro_torch.cluster import motivation
from repro_torch.cluster.dataset import (
    generate_latency_dataset,
    generate_resource_dataset,
)
from repro_torch.cluster.workloads import ONLINE_NAMES
from repro_torch.core.predictors import ALL_MODELS, evaluate, train_test_split
from repro_torch.core.resource_model import ResourcePredictor
from repro_torch.device import resolve_device, sync


def _timed(device, fn, calls=1):
    """(seconds per call, last result) with the device drained."""
    sync(device)
    t0 = time.perf_counter()
    for _ in range(calls):
        out = fn()
    sync(device)
    return (time.perf_counter() - t0) / calls, out


def resource_fits(device):
    """Figs. 6-7: per online workload, (workload, fit seconds, the fitted
    ``ResourcePredictor``, its (qps, cpu, mem) data)."""
    out = []
    for w in ONLINE_NAMES:
        data = generate_resource_dataset(w, seed=0)
        fit_s, rp = _timed(device, lambda: ResourcePredictor(
            device=device).fit(w, *data))
        out.append((w, fit_s, rp, data))
    return out


def resource_rows(device):
    out = []
    for w, fit_s, rp, data in resource_fits(device):
        r2c, r2m = rp.r2(w, *data)
        out.append((
            f"torch.resource_model.{w}", fit_s * 1e6,
            f"r2_cpu={r2c:.3f};r2_mem={r2m:.3f};"
            f"slope_cpu={rp.cpu_fits[w].slope:.4f};"
            f"slope_mem={rp.mem_fits[w].slope:.4f}",
        ))
    return out


def table2_split(device, fast: bool = True):
    """(seconds, (Xtr, Xte, ytr, yte)): Table II's dataset, 250 placements,
    or ``bench_predictors``' 700 when not ``fast``, split at seed 0."""
    n_place = 250 if fast else 700
    data_s, (X, y) = _timed(device, lambda: generate_latency_dataset(
        num_placements=n_place, num_nodes=10, seed=0, device=device))
    return data_s, train_test_split(X, y, seed=0)


def table2_model(name, split, device, fast: bool = True, calls: int = 5):
    """One Table II model fitted on ``split``: (fit seconds, predict seconds
    a call after one untimed call, the model, its test predictions, their
    metrics).  ``fast`` trains the SVR and the MLP for 1,500 steps."""
    Xtr, Xte, ytr, yte = split
    kwargs = {"steps": 1500} if fast and name in ("svm", "mlp") else {}
    fit_s, m = _timed(device, lambda: ALL_MODELS[name](
        **kwargs, device=device).fit(Xtr, ytr))
    m.predict(Xte)
    pred_s, pred = _timed(device, lambda: m.predict(Xte), calls=calls)
    return fit_s, pred_s, m, pred, evaluate(yte, pred)


def predictor_rows(device, fast: bool = True):
    _, split = table2_split(device, fast)
    n = len(split[2]) + len(split[3])
    out = []
    for name in ALL_MODELS:
        fit_s, pred_s, _, _, e = table2_model(name, split, device, fast)
        out.append((
            f"torch.predictors.{name}", pred_s * 1e6,
            f"mae={e['mae']:.2f};mse={e['mse']:.1f};mape={e['mape']:.3f};"
            f"r2={e['r2']:.3f};fit_s={fit_s:.2f};n={n}",
        ))
    return out


def motivation_table(device):
    """(seconds, Table I): ``motivation.table1(0)``, i.e. experiment 1 at
    seed 0 and experiment 2 at seed 100."""
    return _timed(device, lambda: motivation.table1(0, device=device))


def motivation_rows(device):
    wall_s, table = motivation_table(device)
    us = wall_s * 1e6 / 4
    return [(f"torch.motivation.{k.replace('_', '.', 1)}", us,
             f"MAPE={mape:.3f};R2={r2:.3f}")
            for k, (mape, r2) in table.items()]


def run(fast: bool = True, device=None):
    device = resolve_device(device)
    return resource_rows(device) + predictor_rows(device, fast) \
        + motivation_rows(device)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--full", action="store_true",
                    help="Table II at 700 placements")
    args = ap.parse_args()
    print("name,us_per_call,derived")
    for name, us, derived in run(fast=not args.full, device=args.device):
        print(f"{name},{us:.1f},{derived}")


if __name__ == "__main__":
    main()
