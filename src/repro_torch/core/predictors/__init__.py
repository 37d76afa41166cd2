"""ML predictors for scheduling-latency prediction (paper Section IV-C).

Port of ``repro.core.predictors``: the five regressors of Table II --
Linear Regression, Support Vector Machine (SVR), Multilayer Perceptron,
Random Forest and an XGBoost-style gradient-boosted ensemble.  All share
``fit(X, y) -> self`` / ``predict(X) -> tensor`` and take ``device=None``
(the CUDA card).  Random Forest is the production model behind Eq. (3).
"""
from repro_torch.core.predictors.eval import evaluate, train_test_split
from repro_torch.core.predictors.features import FEATURE_NAMES, NUM_FEATURES
from repro_torch.core.predictors.forest import RandomForestRegressor
from repro_torch.core.predictors.gbdt import XGBRegressor
from repro_torch.core.predictors.linear import LinearRegression
from repro_torch.core.predictors.mlp import MLPRegressor
from repro_torch.core.predictors.svm import SVR

ALL_MODELS = {
    "linear_regression": LinearRegression,
    "svm": SVR,
    "mlp": MLPRegressor,
    "random_forest": RandomForestRegressor,
    "xgb": XGBRegressor,
}

__all__ = [
    "ALL_MODELS", "FEATURE_NAMES", "LinearRegression", "MLPRegressor",
    "NUM_FEATURES", "RandomForestRegressor", "SVR", "XGBRegressor",
    "evaluate", "train_test_split",
]
