"""Training launcher.

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --steps 200 --batch 8 --seq 128 [--smoke] [--ckpt-dir DIR] \\
      [--accum 2] [--compress] [--resume] [--device cpu]

Port of ``repro.launch.train``: the same arguments, plus ``--device``
(default: the CUDA card; the CPU only when named).  It wires together
config resolution, the prefetched synthetic data pipeline, the train step
(accumulation, remat, compression), checkpointing with auto-resume and
straggler detection.  Weights are random, from a generator seeded
``seed``.  Every family trains on the card, the large ones only cut: one
card holds AdamW's state for a layer or two of them at full width (a step
keeps ~24 bytes a parameter); on the CPU use ``--smoke``.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data import Prefetcher, SyntheticLM
from repro_torch.device import resolve_device, sync
from repro_torch.models.model import Model
from repro_torch.optim import AdamWConfig
from repro_torch.train import (
    Checkpointer,
    StragglerDetector,
    init_train_state,
    make_train_step,
)


def train_loop(cfg, *, steps: int, global_batch: int, seq_len: int,
               ckpt_dir: str | None = None, ckpt_every: int = 50,
               accum: int = 1, compress: bool = False, resume: bool = False,
               lr: float = 3e-4, log_every: int = 10, seed: int = 0,
               device=None, history: list | None = None):
    """Train ``cfg`` from a seeded random init for ``steps`` steps; returns
    (model, opt_state, losses).  ``history``, when given, receives a dict
    per step: ``step``, ``loss``, ``grad_norm``, ``lr_scale``, ``ms``
    (host wall clock of the step, ended by reading the loss) and
    ``straggler``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    model, opt = init_train_state(Model(cfg, device=dev), gen,
                                  compress=compress)
    ck = Checkpointer(ckpt_dir) if ckpt_dir else None
    start = 0
    if ck and resume:
        params = dict(model.named_parameters())
        restored, step = ck.restore({"params": params, "opt": opt})
        if restored is not None:
            with torch.no_grad():
                for n, p in params.items():
                    p.copy_(restored["params"][n])
            opt, start = restored["opt"], step
            print(f"[train] resumed from step {step}")

    step_fn = make_train_step(
        model, AdamWConfig(lr=lr), accum=accum, compress=compress,
        schedule_kwargs={"warmup": max(10, steps // 20), "total": steps})
    ds = SyntheticLM(cfg.vocab_size, seq_len, global_batch, seed=seed,
                     embed_dim=cfg.d_model if cfg.embed_inputs else 0,
                     mrope=bool(cfg.mrope_sections))
    pf = Prefetcher(ds, start_step=start)
    straggler = StragglerDetector()
    losses = []

    def state():
        return {"params": dict(model.named_parameters()), "opt": opt}

    try:
        for s in range(start, steps):
            t0 = time.perf_counter()
            opt, m = step_fn(opt, pf.next())
            loss = float(m["loss"])  # waits for the step's device work
            sync(dev)
            dur = time.perf_counter() - t0
            verdict = straggler.observe(dur)
            losses.append(loss)
            if history is not None:
                history.append({"step": s, "loss": loss,
                                "grad_norm": float(m["grad_norm"]),
                                "lr_scale": m["lr_scale"], "ms": dur * 1e3,
                                "straggler": verdict["straggler"]})
            if s % log_every == 0 or s == steps - 1:
                print(f"[train] step={s} loss={loss:.4f} "
                      f"gnorm={float(m['grad_norm']):.3f} {dur * 1e3:.0f}ms"
                      + (" STRAGGLER" if verdict["straggler"] else ""))
            if ck and (s + 1) % ckpt_every == 0:
                ck.save(s + 1, state(), async_=True)
        if ck:
            ck.save(steps, state())
            ck.wait()
    finally:
        pf.close()
    return model, opt, losses


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config (CPU-runnable)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    print(f"[train] arch={cfg.name} layers={cfg.num_layers} d={cfg.d_model}")
    _, _, losses = train_loop(
        cfg, steps=args.steps, global_batch=args.batch, seq_len=args.seq,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        accum=args.accum, compress=args.compress, resume=args.resume,
        lr=args.lr, device=args.device)
    k = max(1, len(losses) // 10)
    if losses:
        print(f"[train] first-{k} loss={sum(losses[:k]) / k:.4f} "
              f"last-{k} loss={sum(losses[-k:]) / k:.4f}")
    return losses


if __name__ == "__main__":
    main()
