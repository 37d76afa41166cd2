"""End-to-end training driver on the PyTorch port: train the ~135M
smollm architecture for a few hundred steps on the synthetic pipeline
with checkpoint/restart (the counterpart of ``examples/train_100m.py``).

The full-size config (30L, d=576, 49k vocab = ~134M params) is heavy on a
CPU; by default this runs the same architecture at width 256 (~35M params)
so a few hundred steps finish in minutes.  Pass --full for the real 135M.
Accumulation 2, int8 gradient compression and resume from the last
checkpoint are on, as in the JAX example.

Run: PYTHONPATH=src python examples/torch_train_100m.py [--steps 300]
[--full] [--device cpu] (default device: the CUDA card)
"""
import argparse
import dataclasses
import os
import tempfile

from repro_torch.configs import get_config
from repro_torch.launch.train import train_loop
from repro_torch.models.model import num_params


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--full", action="store_true", help="the real 135M config")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt_100m"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    cfg = get_config("smollm-135m")
    if not args.full:
        cfg = dataclasses.replace(
            cfg, name="smollm-135m-w256", d_model=256, num_heads=4,
            num_kv_heads=2, head_dim=64, d_ff=768, vocab_size=8192,
        )
    print(f"[example] training {cfg.name}: {num_params(cfg) / 1e6:.1f}M "
          f"params, {args.steps} steps, ckpt -> {args.ckpt_dir}")

    _, _, losses = train_loop(
        cfg,
        steps=args.steps,
        global_batch=8,
        seq_len=256,
        ckpt_dir=args.ckpt_dir,
        ckpt_every=100,
        accum=2,
        compress=True,   # int8 gradient compression + error feedback
        resume=True,     # picks up from the last checkpoint if present
        lr=6e-4,
        log_every=25,
        device=args.device,
    )
    k = max(1, len(losses) // 10)
    first, last = sum(losses[:k]) / k, sum(losses[-k:]) / k
    print(f"[example] loss: {first:.3f} -> {last:.3f} "
          f"({'improved' if last < first else 'NO IMPROVEMENT'})")
    return {"first": first, "last": last, "steps": len(losses)}


if __name__ == "__main__":
    main()
