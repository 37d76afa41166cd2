"""Support Vector Regression with an RBF kernel via random Fourier features.

Port of ``repro.core.predictors.svm``: epsilon-insensitive loss plus L2
regularisation, optimised with full-batch Adam on the model's device.  The
random features (``W``, ``phase``) come from a ``torch.Generator`` seeded
with ``seed``, or are passed to ``fit`` (the tests pass JAX's).

The loss is written out with its gradient by hand rather than through
autograd, so the subgradients at the kinks are JAX's: ``jax.grad`` of
``jnp.maximum(a, 0)`` gives 0.5 at a tie and of ``jnp.abs(e)`` gives 0 at
e = 0.  The training loop only queues device work; it never reads a value
back to the host.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.predictors.linear import _standardise
from repro_torch.device import resolve_device


def bias_corrections(steps: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Adam's (1 - 0.9^t, 1 - 0.999^t) for t = 1..steps, float32 on the
    device, as JAX computes them from its float32 step counter."""
    t = torch.arange(1, steps + 1, dtype=torch.float32, device=device)
    return 1 - 0.9 ** t, 1 - 0.999 ** t


def adam_update(p, g, m, v, bc1, bc2, lr):
    """One Adam step in JAX's operation order; returns (p, m, v)."""
    m = 0.9 * m + 0.1 * g
    v = 0.999 * v + 0.001 * g * g
    mhat, vhat = m / bc1, v / bc2
    return p - lr * mhat / (torch.sqrt(vhat) + 1e-8), m, v


def loss_grad(Z, y, w, b, epsilon: float, C: float):
    """Gradient of C * mean(max(|Zw + b - y| - eps, 0)) + 0.5 w.w."""
    e = Z @ w + b - y
    err = e.abs() - epsilon
    slope = torch.where(err > 0, 1.0, torch.where(err == 0, 0.5, 0.0))
    ct = (C / Z.shape[0]) * slope * torch.sign(e)
    return Z.T @ ct + w, ct.sum()


def train(Z, y, w, b, epsilon: float, C: float, lr: float, steps: int):
    """Full-batch Adam on (w, b) for ``steps`` steps."""
    bc1, bc2 = bias_corrections(steps, Z.device)
    mw, vw = torch.zeros_like(w), torch.zeros_like(w)
    mb, vb = torch.zeros_like(b), torch.zeros_like(b)
    for i in range(steps):
        gw, gb = loss_grad(Z, y, w, b, epsilon, C)
        w, mw, vw = adam_update(w, gw, mw, vw, bc1[i], bc2[i], lr)
        b, mb, vb = adam_update(b, gb, mb, vb, bc1[i], bc2[i], lr)
    return w, b


class SVR:
    def __init__(
        self,
        n_features: int = 512,
        gamma: float | None = None,
        epsilon: float = 0.01,
        C: float = 10.0,
        lr: float = 3e-3,
        steps: int = 2000,
        seed: int = 0,
        *,
        device=None,
    ):
        self.n_features = n_features
        self.gamma = gamma
        self.epsilon = epsilon
        self.C = C
        self.lr = lr
        self.steps = steps
        self.seed = seed
        self.device = resolve_device(device)
        self.W = None  # RFF projection
        self.phase = None
        self.w = None
        self.b = None
        self.mu = None
        self.sigma = None
        self.y_mu = 0.0
        self.y_sigma = 1.0

    def _f32(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.float32, device=self.device)

    def _featurize(self, X: torch.Tensor) -> torch.Tensor:
        Xs = (X - self.mu) / self.sigma
        proj = Xs @ self.W + self.phase
        return math.sqrt(2.0 / self.n_features) * torch.cos(proj)

    def fit(self, X, y, *, W=None, phase=None) -> "SVR":
        """``W`` (F, n_features) and ``phase`` (n_features,) replace the
        generator's random features when given."""
        X, y = self._f32(X), self._f32(y)
        self.mu, self.sigma = _standardise(X)
        self.y_mu = y.mean()
        self.y_sigma = torch.clamp_min(y.std(correction=0), 1e-9)
        gamma = self.gamma if self.gamma is not None else 1.0 / X.shape[1]
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        shape = (X.shape[1], self.n_features)
        self.W = (self._f32(W) if W is not None else
                  torch.randn(shape, generator=gen, device=self.device)
                  * math.sqrt(2.0 * gamma))
        self.phase = (self._f32(phase) if phase is not None else
                      torch.rand(self.n_features, generator=gen,
                                 device=self.device) * 2 * math.pi)
        Z = self._featurize(X)
        ys = (y - self.y_mu) / self.y_sigma
        w0 = torch.zeros(self.n_features, device=self.device)
        b0 = torch.zeros((), device=self.device)
        self.w, self.b = train(Z, ys, w0, b0, self.epsilon, self.C, self.lr,
                               self.steps)
        return self

    def predict(self, X) -> torch.Tensor:
        Z = self._featurize(self._f32(X))
        return (Z @ self.w + self.b) * self.y_sigma + self.y_mu
