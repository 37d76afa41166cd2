"""Serving launcher: the batched engine and the paper's runqlat telemetry.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b \\
      --smoke --device cpu --requests 24 --qps 8

Port of ``repro.launch.serve``: the same arguments, plus ``--device``
(default: the CUDA card).  An encoder-only architecture (hubert-xlarge)
exits as JAX's launcher does, and so does one that takes embedding inputs
(qwen2-vl-72b), which JAX's engine cannot serve either.  Weights are
random, from a generator seeded 0.  Every admission's queueing delay
lands in the 200x5 runqlat histogram, the telemetry the ICO scheduler
reads when it places this service as an online pod.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.models.model import Model
from repro_torch.serve import ServeEngine


def refuse_unservable(cfg) -> None:
    """``SystemExit`` for what the token-prompt engine cannot serve."""
    if not cfg.causal:
        raise SystemExit(f"{cfg.name} is encoder-only: no decode/serving "
                         "path")
    if cfg.embed_inputs:
        raise SystemExit(f"{cfg.name} takes embedding inputs: the engine "
                         "serves token prompts only")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--qps", type=float, default=8.0)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    refuse_unservable(cfg)
    device = resolve_device(args.device)
    print(f"[serve] arch={cfg.name} max_batch={args.max_batch} "
          f"device={device}")
    model = Model(cfg, device=device).init_params(
        torch.Generator(device=device).manual_seed(0))
    eng = ServeEngine(model, max_batch=args.max_batch)

    rng = np.random.default_rng(0)
    for _ in range(args.requests):
        prompt = rng.integers(0, cfg.vocab_size,
                              size=(int(rng.integers(4, 16)),))
        eng.submit(prompt, max_new_tokens=args.new_tokens)
        # Poisson-ish arrivals at the requested QPS; serve as we go
        if rng.random() < 0.5:
            eng.step()
        time.sleep(min(rng.exponential(1.0 / args.qps), 0.1))
    stats = eng.run()
    print(f"[serve] finished={stats['finished']} "
          f"avg_latency={stats['avg_latency'] * 1e3:.1f}ms "
          f"p90={stats['p90_latency'] * 1e3:.1f}ms "
          f"ttft={stats['avg_ttft'] * 1e3:.1f}ms "
          f"runqlat_avg={stats['runqlat_avg']:.1f}u")
    return stats


if __name__ == "__main__":
    main()
