"""Decision-tree machinery for the Random Forest (port of
``repro.core.predictors.trees``).

Training is a copy of the JAX package's numpy induction: histogram-binned
CART regression trees (quantile pre-binning, 256 bins, split search by
cumulative sums).  Inference flattens the trees to padded (T, nodes)
tensors and walks all (tree, row) pairs together for a bounded depth, so a
whole forest predicts in a fixed number of launches.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

MAX_BINS = 256


@dataclasses.dataclass
class FlatTree:
    feature: np.ndarray    # (n_nodes,) int32, -1 for leaf
    threshold: np.ndarray  # (n_nodes,) float32
    left: np.ndarray       # (n_nodes,) int32
    right: np.ndarray      # (n_nodes,) int32
    value: np.ndarray      # (n_nodes,) float32 (leaf prediction)


def quantile_bins(X: np.ndarray, max_bins: int = MAX_BINS) -> np.ndarray:
    """Per-feature quantile bin edges, shape (F, max_bins-1)."""
    qs = np.linspace(0, 1, max_bins + 1)[1:-1]
    return np.quantile(X, qs, axis=0).T.astype(np.float64)


def bin_data(X: np.ndarray, edges: np.ndarray) -> np.ndarray:
    """Map raw features to bin indices, shape (N, F)."""
    out = np.empty(X.shape, dtype=np.int16)
    for f in range(X.shape[1]):
        out[:, f] = np.searchsorted(edges[f], X[:, f], side="right")
    return out


def _best_split(binned, grad, hess, rows, feat_subset, n_bins, reg_lambda,
                min_child_weight):
    """Best (feature, bin) split by XGBoost gain over the given rows, or
    None if no split improves."""
    g, h = grad[rows], hess[rows]
    G, H = g.sum(), h.sum()
    parent = (G * G) / (H + reg_lambda)
    best_gain, best_feat, best_bin = 1e-12, -1, -1
    sub = binned[rows][:, feat_subset]
    for j, f in enumerate(feat_subset):
        gb = np.bincount(sub[:, j], weights=g, minlength=n_bins)
        hb = np.bincount(sub[:, j], weights=h, minlength=n_bins)
        gl = np.cumsum(gb)[:-1]
        hl = np.cumsum(hb)[:-1]
        gr, hr = G - gl, H - hl
        valid = (hl >= min_child_weight) & (hr >= min_child_weight)
        gain = np.where(
            valid,
            gl * gl / (hl + reg_lambda) + gr * gr / (hr + reg_lambda) - parent,
            -np.inf,
        )
        k = int(np.argmax(gain))
        if gain[k] > best_gain:
            best_gain, best_feat, best_bin = float(gain[k]), int(f), k
    if best_feat < 0:
        return None
    return best_gain, best_feat, best_bin


def build_tree(binned, edges, grad, hess, rows, *, max_depth: int,
               min_samples_leaf: int, reg_lambda: float, feature_frac: float,
               rng: np.random.Generator, leaf_scale: float = 1.0) -> FlatTree:
    """Grow one tree.  Leaf value = -G/(H+lambda) * leaf_scale (with hess=1
    and grad=-target this is the mean target, i.e. CART)."""
    n_bins = edges.shape[1] + 1
    n_feats = binned.shape[1]
    feats = {"feature": [], "threshold": [], "left": [], "right": [],
             "value": []}

    def new_node():
        for k in feats:
            feats[k].append(0)
        return len(feats["feature"]) - 1

    def leaf(nid, leaf_val):
        feats["feature"][nid] = -1
        feats["threshold"][nid] = 0.0
        feats["left"][nid] = nid
        feats["right"][nid] = nid
        feats["value"][nid] = leaf_val
        return nid

    def grow(rows: np.ndarray, depth: int) -> int:
        nid = new_node()
        g, h = grad[rows], hess[rows]
        G, H = g.sum(), h.sum()
        leaf_val = float(-G / (H + reg_lambda) * leaf_scale)
        split = None
        if depth < max_depth and rows.size >= 2 * min_samples_leaf:
            k = max(1, int(round(feature_frac * n_feats)))
            feat_subset = rng.choice(n_feats, size=k, replace=False)
            split = _best_split(
                binned, grad, hess, rows, feat_subset, n_bins, reg_lambda,
                min_child_weight=float(min_samples_leaf) * 1e-3,
            )
        if split is None:
            return leaf(nid, leaf_val)
        _, f, b = split
        mask = binned[rows, f] <= b
        l_rows, r_rows = rows[mask], rows[~mask]
        if l_rows.size < min_samples_leaf or r_rows.size < min_samples_leaf:
            return leaf(nid, leaf_val)
        feats["feature"][nid] = f
        feats["threshold"][nid] = (float(edges[f][b]) if b < edges.shape[1]
                                   else np.inf)
        feats["value"][nid] = leaf_val
        feats["left"][nid] = grow(l_rows, depth + 1)
        feats["right"][nid] = grow(r_rows, depth + 1)
        return nid

    grow(rows, 0)
    return FlatTree(
        feature=np.asarray(feats["feature"], np.int32),
        threshold=np.asarray(feats["threshold"], np.float32),
        left=np.asarray(feats["left"], np.int32),
        right=np.asarray(feats["right"], np.int32),
        value=np.asarray(feats["value"], np.float32),
    )


def pad_forest(trees: list[FlatTree], *, device) -> dict:
    """Stack trees into padded (T, n_nodes_max) tensors.  Indices are int64
    so the traversal can gather with them directly."""
    n = max(t.feature.size for t in trees)
    T = len(trees)
    feature = np.full((T, n), -1, np.int64)
    threshold = np.zeros((T, n), np.float32)
    left = np.zeros((T, n), np.int64)
    right = np.zeros((T, n), np.int64)
    value = np.zeros((T, n), np.float32)
    for i, t in enumerate(trees):
        m = t.feature.size
        feature[i, :m] = t.feature
        threshold[i, :m] = t.threshold
        left[i, :m] = t.left
        right[i, :m] = t.right
        value[i, :m] = t.value
    arrays = dict(feature=feature, threshold=threshold, left=left,
                  right=right, value=value)
    return {k: torch.as_tensor(v, device=device) for k, v in arrays.items()}


def forest_predict(forest: dict, X: torch.Tensor, max_depth: int
                   ) -> torch.Tensor:
    """(T, N) leaf values: every tree and row walked together for
    ``max_depth + 1`` steps (a leaf points at itself)."""
    X = X.float()
    feature, threshold = forest["feature"], forest["threshold"]
    left, right = forest["left"], forest["right"]
    T, N = feature.shape[0], X.shape[0]
    Xt = X.t()                                               # (F, N)
    cols = torch.arange(N, device=X.device).expand(T, N)
    idx = torch.zeros((T, N), dtype=torch.int64, device=X.device)
    for _ in range(max_depth + 1):
        f = feature.gather(1, idx)                           # (T, N)
        xf = Xt[f.clamp(min=0), cols]
        go_left = xf <= threshold.gather(1, idx)
        nxt = torch.where(go_left, left.gather(1, idx), right.gather(1, idx))
        idx = torch.where(f < 0, idx, nxt)
    return forest["value"].gather(1, idx)


def tree_rows(preds: torch.Tensor) -> torch.Tensor:
    """A (T, N) prediction as contiguous (N, T) rows, to reduce over the
    trees along the last axis: every row then takes the same order of
    additions, so identical rows get identical results, as in XLA's
    reduce.  Over axis 0 of the (T, N) layout the CPU's trailing columns
    take another vector path, so two nodes with the same leaves could
    differ by an ulp and break ICO's argmax ties unlike JAX."""
    return preds.t().contiguous()
