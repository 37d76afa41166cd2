"""Deterministic synthetic token pipeline: sharded, prefetching.

Port of ``repro.data.pipeline``, which is numpy only: the same draws in
the same order, so a batch equals JAX's bit for bit (tokens, labels,
``embeds``, ``positions``, ``mask``).  Batches stay numpy arrays; the
train step moves them to the model's device.

Each host materializes only its shard of the global batch (shard = slice
along batch dim by process index), so the pipeline scales to any host
count.  Tokens follow a Zipf-ish distribution with local n-gram structure
(repeated spans) so losses are non-trivial.  A few background threads keep
the next batches drawn.
"""
from __future__ import annotations

import collections
from concurrent.futures import ThreadPoolExecutor

import numpy as np


class SyntheticLM:
    def __init__(
        self,
        vocab_size: int,
        seq_len: int,
        global_batch: int,
        seed: int = 0,
        num_hosts: int = 1,
        host_id: int = 0,
        embed_dim: int = 0,      # >0: emit embeddings (stub frontends)
        mrope: bool = False,
    ):
        assert global_batch % num_hosts == 0
        self.vocab = vocab_size
        self.seq = seq_len
        self.local_batch = global_batch // num_hosts
        self.seed = seed
        self.host_id = host_id
        self.embed_dim = embed_dim
        self.mrope = mrope
        # Zipf weights over vocab
        ranks = np.arange(1, vocab_size + 1)
        w = 1.0 / ranks**1.1
        self.probs = w / w.sum()

    def batch(self, step: int) -> dict:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.host_id])
        )
        B, S = self.local_batch, self.seq
        toks = rng.choice(self.vocab, size=(B, S), p=self.probs).astype(np.int32)
        # inject span repeats for learnable structure
        for b in range(B):
            n_rep = rng.integers(1, 4)
            for _ in range(n_rep):
                ln = int(rng.integers(4, min(32, S // 2)))
                src = int(rng.integers(0, S - 2 * ln))
                dst = int(rng.integers(src + ln, S - ln))
                toks[b, dst : dst + ln] = toks[b, src : src + ln]
        labels = np.concatenate([toks[:, 1:], toks[:, :1]], axis=1)
        out = {"labels": labels, "mask": np.ones((B, S), np.float32)}
        if self.embed_dim:
            emb_rng = np.random.default_rng(
                np.random.SeedSequence([self.seed + 7, step, self.host_id])
            )
            out["embeds"] = emb_rng.normal(0, 1, (B, S, self.embed_dim)).astype(
                np.float32
            )
            if self.mrope:
                pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
                out["positions"] = np.stack([pos, pos, pos])
        else:
            out["tokens"] = toks
        return out


# threads drawing batches ahead: numpy draws without holding the GIL, so a
# batch that takes longer to draw than a step takes to train comes this
# many times as fast (qwen2-vl's (8, 1,024, 8,192) embeddings take ~1.5 s
# to draw, its train step ~0.5 s on an H100)
WORKERS = 4


class Prefetcher:
    """Background prefetch of dataset batches, handed out in step order:
    the next ``depth`` steps are drawn at once, by up to WORKERS
    threads."""

    def __init__(self, dataset, start_step: int = 0, depth: int = WORKERS):
        self.dataset = dataset
        self.step = start_step
        self._pool = ThreadPoolExecutor(max_workers=min(depth, WORKERS),
                                        thread_name_prefix="prefetch")
        self._pending = collections.deque(
            self._pool.submit(dataset.batch, s)
            for s in range(start_step, start_step + depth))
        self._next = start_step + depth

    def next(self) -> dict:
        batch = self._pending.popleft().result()
        self._pending.append(self._pool.submit(self.dataset.batch,
                                               self._next))
        self._next += 1
        return batch

    def close(self):
        self._pending.clear()
        self._pool.shutdown(wait=True, cancel_futures=True)
