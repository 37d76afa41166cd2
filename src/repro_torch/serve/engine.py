"""Batched serving engine with continuous batching and the paper's metric.

Port of ``repro.serve.engine``.  Requests queue with arrival timestamps;
the engine admits up to ``max_batch`` requests per cohort.  The interval
between a request becoming runnable and being admitted is the serving-side
analogue of the paper's scheduling latency: it goes into the same 200x5
histogram (``RunqlatCollector``), which makes every serving job an online
pod for the ICO scheduler.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque

import numpy as np
import torch

from repro_torch.core.metric import RunqlatCollector


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray          # (S,) int32
    max_new_tokens: int
    arrival: float = 0.0
    tokens: list = dataclasses.field(default_factory=list)
    enqueue_t: float = 0.0      # when it became runnable (for runqlat)
    first_token_t: float | None = None
    done_t: float | None = None


class ServeEngine:
    """Synchronous continuous-batching engine with greedy decoding.

    Each admitted cohort decodes together at one cache length: prompts are
    left-padded with token 0 to the cohort's longest, with no padding mask,
    exactly as the JAX engine does.  Prompts are token ids, as JAX's engine
    takes them: a model with ``embed_inputs`` (qwen2-vl-72b, hubert-xlarge)
    is refused.
    """

    def __init__(self, model, max_batch: int = 8, latency_unit: float = 1e-3):
        if model.cfg.embed_inputs:
            raise ValueError(f"{model.cfg.name} takes embedding inputs; the "
                             "engine serves token prompts only")
        self.model = model
        self.max_batch = max_batch
        self.latency_unit = latency_unit  # seconds per histogram unit
        self.queue: deque[Request] = deque()
        self.finished: list[Request] = []
        self.runqlat = RunqlatCollector()
        self._uid = 0

    def submit(self, prompt: np.ndarray, max_new_tokens: int = 16) -> int:
        now = time.monotonic()
        req = Request(self._uid, np.asarray(prompt, np.int32), max_new_tokens,
                      arrival=now, enqueue_t=now)
        self.queue.append(req)
        self._uid += 1
        return req.uid

    def _admit(self) -> list[Request]:
        cohort = []
        now = time.monotonic()
        while self.queue and len(cohort) < self.max_batch:
            req = self.queue.popleft()
            # queueing delay in latency units -> the paper's runqlat metric
            self.runqlat.add([(now - req.enqueue_t) / self.latency_unit])
            cohort.append(req)
        return cohort

    def step(self) -> int:
        """Process one cohort to completion.  Returns #requests finished."""
        cohort = self._admit()
        if not cohort:
            return 0
        B = len(cohort)
        S = max(len(r.prompt) for r in cohort)
        toks = np.zeros((B, S), np.int32)
        for i, r in enumerate(cohort):
            toks[i, S - len(r.prompt):] = r.prompt  # left-pad
        new_tokens = int(max(r.max_new_tokens for r in cohort))
        # JAX prefills into a cache of S positions and re-materialises it
        # at S + new_tokens (_grow_cache); here prefill fills a cache
        # allocated at S + new_tokens in place.
        logits, cache = self.model.prefill(
            torch.as_tensor(toks, dtype=torch.long, device=self.model.device),
            max_seq=S + new_tokens)
        tok = torch.argmax(logits, dim=-1)[:, None]
        # the tokens reach the host before the stamp, so it sees done work
        host = tok[:, 0].tolist()
        now = time.monotonic()
        for r, t in zip(cohort, host):
            r.first_token_t = now
            r.tokens.append(t)
        for _ in range(new_tokens - 1):
            logits, cache = self.model.decode_step(tok, cache)
            tok = torch.argmax(logits, dim=-1)[:, None]
            for r, t in zip(cohort, tok[:, 0].tolist()):
                if len(r.tokens) < r.max_new_tokens:
                    r.tokens.append(t)
        now = time.monotonic()
        for r in cohort:
            r.done_t = now
            self.finished.append(r)
        return len(cohort)

    def run(self) -> dict:
        while self.queue:
            self.step()
        return self.stats()

    def stats(self) -> dict:
        lats = [r.done_t - r.arrival for r in self.finished
                if r.done_t is not None]
        ttfts = [r.first_token_t - r.arrival for r in self.finished
                 if r.first_token_t is not None]
        return {
            "finished": len(self.finished),
            "avg_latency": float(np.mean(lats)) if lats else 0.0,
            "p90_latency": float(np.percentile(lats, 90)) if lats else 0.0,
            "avg_ttft": float(np.mean(ttfts)) if ttfts else 0.0,
            "runqlat_avg": self.runqlat.average(),
            "runqlat_hist": self.runqlat.snapshot(),
        }
