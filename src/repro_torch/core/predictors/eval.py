"""Evaluation metrics used by the paper's Table II: MAE, MSE, MAPE, R2."""
from __future__ import annotations

import numpy as np


def train_test_split(X, y, test_frac: float = 0.25, seed: int = 0):
    rng = np.random.default_rng(seed)
    n = X.shape[0]
    perm = rng.permutation(n)
    k = int(n * (1 - test_frac))
    tr, te = perm[:k], perm[k:]
    return X[tr], X[te], y[tr], y[te]


def evaluate(y_true: np.ndarray, y_pred: np.ndarray) -> dict:
    y_true = np.asarray(y_true, np.float64)
    y_pred = np.asarray(y_pred, np.float64)
    err = y_pred - y_true
    mae = float(np.abs(err).mean())
    mse = float((err**2).mean())
    denom = np.maximum(np.abs(y_true), 1e-9)
    mape = float((np.abs(err) / denom).mean())
    ss_res = float((err**2).sum())
    ss_tot = float(((y_true - y_true.mean()) ** 2).sum())
    r2 = 1.0 - ss_res / max(ss_tot, 1e-12)
    return {"mae": mae, "mse": mse, "mape": mape, "r2": r2}
