"""Linear Regression predictor (closed-form ridge).

Port of ``repro.core.predictors.linear``: standardised features and the
normal equations with a ``reg`` ridge term, solved by
``torch.linalg.solve`` on the model's device.  The fit runs in float64 on
the inputs rounded to float32, as JAX's are, and keeps float32 parameters;
prediction is float32, as JAX's.  In float32 the 1e-6 ridge rounds away
beside diagonal entries of ~n, so exactly collinear columns (Table III's
band masses sum to one) leave the system singular (JAX's LU returns NaN)
and a float32 fit follows the solver's pivots; in float64 the ridge holds
and the fit is the same on every device.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device


def _standardise(X: torch.Tensor):
    """Column mean and population std (clamped at 1e-9), as ``jnp.std``."""
    return X.mean(0), torch.clamp_min(X.std(0, correction=0), 1e-9)


class LinearRegression:
    def __init__(self, reg: float = 1e-6, *, device=None):
        self.reg = reg
        self.device = resolve_device(device)
        self.w = None
        self.mu = None
        self.sigma = None
        self.y_mu = 0.0

    def _f32(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.float32, device=self.device)

    def fit(self, X, y) -> "LinearRegression":
        X, y = self._f32(X).double(), self._f32(y).double()
        mu, sigma = _standardise(X)
        y_mu = y.mean()
        Xs = (X - mu) / sigma
        eye = torch.eye(Xs.shape[1], dtype=Xs.dtype, device=self.device)
        w = torch.linalg.solve(Xs.T @ Xs + self.reg * eye, Xs.T @ (y - y_mu))
        self.mu, self.sigma, self.w, self.y_mu = (
            t.float() for t in (mu, sigma, w, y_mu))
        return self

    def predict(self, X) -> torch.Tensor:
        Xs = (self._f32(X) - self.mu) / self.sigma
        return Xs @ self.w + self.y_mu
