"""Random Forest regressor -- the paper's production model (Table II).

Port of ``repro.core.predictors.forest``: bootstrap-sampled CART trees
grown in numpy (the JAX package's induction, copied), prediction on
tensors over (trees x rows).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.predictors import trees as T
from repro_torch.device import resolve_device


class RandomForestRegressor:
    def __init__(
        self,
        n_estimators: int = 40,
        max_depth: int = 10,
        min_samples_leaf: int = 4,
        feature_frac: float = 0.6,
        seed: int = 0,
        *,
        device=None,
    ):
        self.n_estimators = n_estimators
        self.max_depth = max_depth
        self.min_samples_leaf = min_samples_leaf
        self.feature_frac = feature_frac
        self.seed = seed
        self.device = resolve_device(device)
        self.forest = None

    def fit(self, X: np.ndarray, y: np.ndarray) -> "RandomForestRegressor":
        X = np.asarray(X, np.float64)
        y = np.asarray(y, np.float64)
        rng = np.random.default_rng(self.seed)
        edges = T.quantile_bins(X)
        binned = T.bin_data(X, edges)
        # CART via the XGB leaf formula: grad = -y, hess = 1 -> mean(y)
        hess = np.ones_like(y)
        flats = []
        n = X.shape[0]
        for _ in range(self.n_estimators):
            rows = rng.integers(0, n, size=n)  # bootstrap
            flats.append(
                T.build_tree(
                    binned, edges, -y, hess, rows,
                    max_depth=self.max_depth,
                    min_samples_leaf=self.min_samples_leaf,
                    reg_lambda=1e-6,
                    feature_frac=self.feature_frac,
                    rng=rng,
                )
            )
        self.forest = T.pad_forest(flats, device=self.device)
        return self

    def predict(self, X) -> torch.Tensor:
        """(N, F) rows (tensor or array) -> (N,) float32 predictions."""
        X = torch.as_tensor(X, dtype=torch.float32, device=self.device)
        return T.tree_rows(T.forest_predict(self.forest, X,
                                            self.max_depth)).mean(-1)
