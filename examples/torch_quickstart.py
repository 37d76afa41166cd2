"""Quickstart on the PyTorch port: the paper's full pipeline (the
counterpart of ``examples/quickstart.py``).

1. Simulate a co-location cluster and collect runqlat telemetry.
2. Train the Random Forest scheduling-latency predictor (Eq. 3).
3. Schedule pods with ICO (Algorithm 1) vs the three baselines.
4. Print the paper's comparison (Fig. 13-15 analogue).

Run: PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
(default device: the CUDA card).
"""
import argparse

from repro_torch.cluster.dataset import generate_latency_dataset
from repro_torch.cluster.experiment import compare_schedulers
from repro_torch.core.predictors import (
    RandomForestRegressor,
    evaluate,
    train_test_split,
)
from repro_torch.device import resolve_device


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    device = resolve_device(ap.parse_args().device)

    print("== 1/3: generating telemetry + training the predictor ==")
    X, y = generate_latency_dataset(num_placements=150, num_nodes=10, seed=0,
                                    device=device)
    Xtr, Xte, ytr, yte = train_test_split(X, y)
    rf = RandomForestRegressor(n_estimators=30, seed=0,
                               device=device).fit(Xtr, ytr)
    e = evaluate(yte, rf.predict(Xte))
    print(f"   random forest on {len(y)} placements: "
          f"r2={e['r2']:.3f} mae={e['mae']:.1f} latency-units")

    print("== 2/3: running the scheduler comparison (identical traces) ==")
    res = compare_schedulers(num_pods=40, num_nodes=12, seed=7, predictor=rf,
                             device=device)

    print("== 3/3: results ==")
    print(f"{'sched':6s}{'avg_rt':>9s}{'p90_rt':>9s}{'p99_rt':>9s}"
          f"{'cpu_std':>9s}{'mem_std':>9s}")
    for name, r in res.items():
        print(f"{name:6s}{r.avg_rt:9.2f}{r.p90_rt:9.2f}{r.p99_rt:9.2f}"
              f"{r.cpu_util_std:9.2f}{r.mem_util_std:9.2f}")
    hup, ico = res["HUP"], res["ICO"]
    print(f"\nICO vs HUP: avg {100 * (1 - ico.avg_rt / hup.avg_rt):+.1f}%  "
          f"p90 {100 * (1 - ico.p90_rt / hup.p90_rt):+.1f}%  "
          f"p99 {100 * (1 - ico.p99_rt / hup.p99_rt):+.1f}%  "
          f"(paper reductions: 29.4% / 31.4% / 14.5%)")


if __name__ == "__main__":
    main()
