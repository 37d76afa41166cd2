"""XGBoost-style gradient-boosted regression trees (squared loss).

Port of ``repro.core.predictors.gbdt``: second-order boosting on the
shared tree machinery (grad = pred - y, hess = 1, leaf = -G/(H+lambda) *
learning_rate, per-tree row and feature subsampling).  Trees are grown in
numpy float64 with the residual update on the host, exactly as the JAX
package grows them; prediction sums every tree on the model's device.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.predictors import trees as T
from repro_torch.device import resolve_device


class XGBRegressor:
    def __init__(
        self,
        n_estimators: int = 60,
        max_depth: int = 6,
        learning_rate: float = 0.15,
        reg_lambda: float = 1.0,
        subsample: float = 0.8,
        feature_frac: float = 0.8,
        min_samples_leaf: int = 4,
        seed: int = 0,
        *,
        device=None,
    ):
        self.n_estimators = n_estimators
        self.max_depth = max_depth
        self.learning_rate = learning_rate
        self.reg_lambda = reg_lambda
        self.subsample = subsample
        self.feature_frac = feature_frac
        self.min_samples_leaf = min_samples_leaf
        self.seed = seed
        self.device = resolve_device(device)
        self.forest = None
        self.base = 0.0

    def fit(self, X: np.ndarray, y: np.ndarray) -> "XGBRegressor":
        X = np.asarray(X, np.float64)
        y = np.asarray(y, np.float64)
        rng = np.random.default_rng(self.seed)
        edges = T.quantile_bins(X)
        binned = T.bin_data(X, edges)
        self.base = float(y.mean())
        pred = np.full_like(y, self.base)
        hess = np.ones_like(y)
        n = X.shape[0]
        flats = []
        for _ in range(self.n_estimators):
            grad = pred - y
            rows = rng.choice(n, size=max(1, int(self.subsample * n)),
                              replace=False)
            tree = T.build_tree(
                binned, edges, grad, hess, rows,
                max_depth=self.max_depth,
                min_samples_leaf=self.min_samples_leaf,
                reg_lambda=self.reg_lambda,
                feature_frac=self.feature_frac,
                rng=rng,
                leaf_scale=self.learning_rate,
            )
            flats.append(tree)
            pred += self._predict_one(tree, X)
        self.forest = T.pad_forest(flats, device=self.device)
        return self

    @staticmethod
    def _predict_one(tree: T.FlatTree, X: np.ndarray) -> np.ndarray:
        """Host-side float64 walk of one tree (the residual update)."""
        idx = np.zeros(X.shape[0], np.int64)
        for _ in range(64):  # bounded depth
            f = tree.feature[idx]
            leaf = f < 0
            if leaf.all():
                break
            fx = X[np.arange(X.shape[0]), np.maximum(f, 0)]
            nxt = np.where(fx <= tree.threshold[idx], tree.left[idx],
                           tree.right[idx])
            idx = np.where(leaf, idx, nxt)
        return tree.value[idx].astype(np.float64)

    def predict(self, X) -> torch.Tensor:
        """(N, F) rows (tensor or array) -> (N,) float32 predictions."""
        X = torch.as_tensor(X, dtype=torch.float32, device=self.device)
        return (T.tree_rows(T.forest_predict(self.forest, X,
                                             self.max_depth)).sum(-1)
                + self.base)
