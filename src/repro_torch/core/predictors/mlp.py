"""Multilayer Perceptron regressor (Adam on minibatches).

Port of ``repro.core.predictors.mlp``: a ReLU MLP as an ``nn.Module`` whose
weights keep JAX's (in, out) layout, trained on the model's device with
autograd gradients and JAX's Adam update.  The He init and each step's
minibatch indices come from a ``torch.Generator`` seeded with ``seed``, or
are passed to ``fit`` (the tests pass JAX's init and index stream).  The
training loop only queues device work; it never reads a value back.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.core.predictors.linear import _standardise
from repro_torch.core.predictors.svm import adam_update, bias_corrections
from repro_torch.device import resolve_device


class MLP(nn.Module):
    """relu(x @ w + b) per hidden layer, then a linear scalar head."""

    def __init__(self, params: list[dict]):
        super().__init__()
        self.w = nn.ParameterList([nn.Parameter(p["w"]) for p in params])
        self.b = nn.ParameterList([nn.Parameter(p["b"]) for p in params])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for w, b in zip(self.w[:-1], self.b[:-1]):
            x = torch.relu(x @ w + b)
        return (x @ self.w[-1] + self.b[-1])[..., 0]


def init_params(sizes, generator: torch.Generator, device) -> list[dict]:
    """He-normal weights and zero biases for layer sizes ``sizes``."""
    return [{"w": torch.randn((sizes[i], sizes[i + 1]), generator=generator,
                              device=device) * math.sqrt(2.0 / sizes[i]),
             "b": torch.zeros(sizes[i + 1], device=device)}
            for i in range(len(sizes) - 1)]


def train(model: MLP, X, y, lr: float, idx: torch.Tensor) -> None:
    """Adam on the squared loss of minibatch ``idx[i]`` at step i."""
    params = list(model.parameters())
    bc1, bc2 = bias_corrections(idx.shape[0], X.device)
    m = [torch.zeros_like(p) for p in params]
    v = [torch.zeros_like(p) for p in params]
    for i in range(idx.shape[0]):
        rows = idx[i]
        loss = ((model(X[rows]) - y[rows]) ** 2).mean()
        grads = torch.autograd.grad(loss, params)
        with torch.no_grad():
            for j, (p, g) in enumerate(zip(params, grads)):
                new, m[j], v[j] = adam_update(p, g, m[j], v[j], bc1[i],
                                              bc2[i], lr)
                p.copy_(new)


class MLPRegressor:
    def __init__(
        self,
        hidden=(64, 64),
        lr: float = 1e-3,
        steps: int = 3000,
        batch: int = 256,
        seed: int = 0,
        *,
        device=None,
    ):
        self.hidden = tuple(hidden)
        self.lr = lr
        self.steps = steps
        self.batch = batch
        self.seed = seed
        self.device = resolve_device(device)
        self.model = None
        self.mu = None
        self.sigma = None
        self.y_mu = 0.0
        self.y_sigma = 1.0

    def _f32(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.float32, device=self.device)

    def fit(self, X, y, *, params=None, idx=None) -> "MLPRegressor":
        """``params`` (a list of {"w": (in, out), "b": (out,)}) replaces the
        He init and ``idx`` (steps, batch) the minibatch rows."""
        X, y = self._f32(X), self._f32(y)
        self.mu, self.sigma = _standardise(X)
        self.y_mu = y.mean()
        self.y_sigma = torch.clamp_min(y.std(correction=0), 1e-9)
        Xs = (X - self.mu) / self.sigma
        ys = (y - self.y_mu) / self.y_sigma
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        if params is None:
            params = init_params([X.shape[1], *self.hidden, 1], gen,
                                 self.device)
        else:
            params = [{k: self._f32(a).clone() for k, a in p.items()}
                      for p in params]
        if idx is None:
            idx = torch.randint(0, X.shape[0], (self.steps, self.batch),
                                generator=gen, device=self.device)
        else:
            idx = torch.as_tensor(idx, dtype=torch.int64, device=self.device)
        self.model = MLP(params)
        train(self.model, Xs, ys, self.lr, idx)
        return self

    def predict(self, X) -> torch.Tensor:
        Xs = (self._f32(X) - self.mu) / self.sigma
        with torch.no_grad():
            return self.model(Xs) * self.y_sigma + self.y_mu
