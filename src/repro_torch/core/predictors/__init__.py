"""Scheduling-latency predictors (Eq. 3).  This slice ports the production
Random Forest; the linear, SVM, MLP and GBDT models of Table II are queued
in ROADMAP.md."""
from repro_torch.core.predictors.eval import evaluate, train_test_split
from repro_torch.core.predictors.features import FEATURE_NAMES, NUM_FEATURES
from repro_torch.core.predictors.forest import RandomForestRegressor

__all__ = [
    "FEATURE_NAMES", "NUM_FEATURES", "RandomForestRegressor", "evaluate",
    "train_test_split",
]
