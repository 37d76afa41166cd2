"""Batched serving demo on the PyTorch port: continuous batching over a
bursty arrival stream, with the paper's scheduling-latency histogram
collected per admission (the counterpart of ``examples/serve_demo.py``).

Run: PYTHONPATH=src python examples/torch_serve_demo.py [--arch gemma3-4b]
[--device cpu] (default device: the CUDA card; ``--arch`` takes every
architecture with token prompts and a decode path, served at its smoke
config: not hubert-xlarge, an encoder, nor qwen2-vl-72b, which takes
embeddings).
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core import metric
from repro_torch.device import resolve_device
from repro_torch.launch.serve import refuse_unservable
from repro_torch.models.model import Model
from repro_torch.serve import ServeEngine


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--requests", type=int, default=20)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch)
    refuse_unservable(cfg)
    device = resolve_device(args.device)
    print(f"[serve_demo] arch={cfg.name} (smoke config) device={device}")
    model = Model(cfg, device=device).init_params(
        torch.Generator(device=device).manual_seed(0))
    eng = ServeEngine(model, max_batch=4, latency_unit=1e-3)

    rng = np.random.default_rng(0)
    t0 = time.time()
    # bursty arrivals: two bursts with a quiet gap
    for _ in range(2):
        for _ in range(args.requests // 2):
            n = int(rng.integers(4, 20))
            eng.submit(rng.integers(0, cfg.vocab_size, size=(n,)),
                       max_new_tokens=int(rng.integers(2, 6)))
        eng.step()  # serve one cohort immediately; the rest queue (-> runqlat)
        time.sleep(0.2)
    stats = eng.run()
    wall = time.time() - t0

    print(f"[serve_demo] finished={stats['finished']} in {wall:.1f}s")
    print(f"  avg latency  {stats['avg_latency'] * 1e3:8.1f} ms")
    print(f"  p90 latency  {stats['p90_latency'] * 1e3:8.1f} ms")
    print(f"  avg TTFT     {stats['avg_ttft'] * 1e3:8.1f} ms")
    print(f"  admission runqlat avg {stats['runqlat_avg']:.1f} units "
          f"(1 unit = 1 ms)")
    h = stats["runqlat_hist"]
    p90 = float(metric.percentile(torch.as_tensor(h, dtype=torch.float32),
                                  90))
    print(f"  admission runqlat p90 {p90:.0f} units")
    nz = np.nonzero(h)[0]
    print(f"  histogram support: bins {nz.min()}..{nz.max()} "
          f"({int(h.sum())} samples in 200x5 bins)")
    return dict(stats, wall_s=wall, runqlat_p90=p90, arch=cfg.name)


if __name__ == "__main__":
    main()
