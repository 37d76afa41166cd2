"""The port's resource model and Table II regressors against
``repro.core.resource_model`` and ``repro.core.predictors``.

The random draws of the two trained-by-gradient models (the SVR's random
Fourier features, the MLP's He init and minibatch indices) are JAX's,
injected into the port's ``fit``; the tree models grow identical trees
from the same numpy generator.  Then the cases of ``tests/test_predictors.py``
run on the port.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cluster.dataset import generate_latency_dataset as jdata
from repro.cluster.dataset import generate_resource_dataset as jres
from repro.cluster.workloads import ONLINE_NAMES
from repro.core import predictors as JP
from repro.core import resource_model as JRM
from repro.core.predictors.mlp import _init as jax_mlp_init
from repro_torch.cluster.dataset import generate_resource_dataset
from repro_torch.convert import predictor_from_numpy
from repro_torch.core import predictors as TP
from repro_torch.core import resource_model as TRM
from repro_torch.core.predictors import svm as tsvm

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the module's tests: under the suite's
    several worker processes, torch's default of one thread a core in each
    makes their small CPU kernels spin against each other, and alone on an
    8-core CPU the module took 32 s at one thread against 49 s at eight."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _linear_data(n=400, d=8, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(0, 1, (n, d))
    w = rng.normal(0, 1, d)
    y = X @ w + 0.01 * rng.normal(size=n)
    return X, y


def _nonlinear_data(n=600, d=6, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2, 2, (n, d))
    y = (np.sin(2 * X[:, 0]) * 3 + np.where(X[:, 1] > 0.5, 5.0, 0.0)
         + X[:, 2] ** 2 + 0.05 * rng.normal(size=n))
    return X, y


@pytest.fixture(scope="module")
def table3():
    """The 40-placement Table-III dataset (the JAX generator, seed 0),
    split as ``bench_predictors`` splits it."""
    X, y = jdata(num_placements=40, num_nodes=6, seed=0)
    return JP.train_test_split(X, y, seed=0)


def _mlp_stream(seed, n_rows, steps, batch):
    """JAX ``MLPRegressor.fit``'s minibatch indices, (steps, batch)."""
    def step(key, _):
        key, k = jax.random.split(key)
        return key, jax.random.randint(k, (batch,), 0, n_rows)

    key = jax.random.fold_in(jax.random.PRNGKey(seed), 7)
    return np.array(jax.lax.scan(step, key, None, length=steps)[1])


def _fit_pair(name, Xtr, ytr, **kw):
    """Fit JAX's model and the port's on the same draws."""
    jm = JP.ALL_MODELS[name](**kw).fit(Xtr, ytr)
    tm = TP.ALL_MODELS[name](**kw, device=CPU)
    if name == "svm":
        tm.fit(Xtr, ytr, W=np.array(jm.W), phase=np.array(jm.phase))
    elif name == "mlp":
        sizes = [Xtr.shape[1], *tm.hidden, 1]
        init = jax_mlp_init(jax.random.PRNGKey(tm.seed), sizes)
        tm.fit(Xtr, ytr, params=[{k: np.array(v) for k, v in p.items()}
                                 for p in init],
               idx=_mlp_stream(tm.seed, Xtr.shape[0], tm.steps, tm.batch))
    else:
        tm.fit(Xtr, ytr)
    return jm, tm


# ---------------- resource model (Figs. 6-7) ----------------

@pytest.mark.parametrize("workload", ONLINE_NAMES)
def test_resource_model_matches_jax_in_float64(workload):
    """JAX's fit is float64 only with x64 on (its default run is float32);
    held so, the port's float64 fit agrees to 1e-12."""
    qps, cpu, mem = generate_resource_dataset(workload, seed=1)
    for a, b in zip((qps, cpu, mem), jres(workload, seed=1)):
        np.testing.assert_array_equal(a, b)
    with jax.enable_x64(True):
        want = JRM.ResourcePredictor().fit(workload, qps, cpu, mem)
        want_r2 = want.r2(workload, qps, cpu, mem)
    got = TRM.ResourcePredictor(device=CPU).fit(workload, qps, cpu, mem)
    for kind in ("cpu_fits", "mem_fits"):
        g, w = getattr(got, kind)[workload], getattr(want, kind)[workload]
        assert g.slope == pytest.approx(w.slope, rel=1e-12)
        assert g.intercept == pytest.approx(w.intercept, rel=1e-12)
    np.testing.assert_allclose(got.r2(workload, qps, cpu, mem), want_r2,
                               rtol=1e-12)
    for q in (0.0, 300.0, 1e4):
        np.testing.assert_allclose(got.predict(workload, q),
                                   want.predict(workload, q), rtol=1e-12)
    assert min(got.r2(workload, qps, cpu, mem)) > 0.9   # Figs. 6-7: linear


def test_fit_line_is_float64_and_clamps():
    x = np.array([0.0, 1.0, 2.0])
    fit = TRM.fit_line(x, np.array([1.0, 3.0, 5.0]), device=CPU)
    assert (fit.slope, fit.intercept) == (2.0, 1.0)
    flat = TRM.fit_line(np.ones(4), np.arange(4.0), device=CPU)
    assert flat.slope == 0.0           # var clamped at 1e-12, no division by 0
    with pytest.raises(TypeError, match="float64"):
        TRM.fit_line(torch.ones(3), torch.ones(3), device=CPU)
    rp = TRM.ResourcePredictor(device=CPU)
    rp.cpu_fits["w"] = TRM.LinearFit(1.0, -5.0)
    rp.mem_fits["w"] = TRM.LinearFit(0.5, 1.0)
    assert rp.predict("w", 2.0) == (0.0, 2.0)           # clamped at zero


# ---------------- Table II regressors ----------------

def test_all_models_keys_equal_jax():
    assert list(TP.ALL_MODELS) == list(JP.ALL_MODELS)


@pytest.mark.parametrize("data", [_linear_data, _nonlinear_data])
def test_linear_regression_matches_jax(data):
    X, y = data()
    Xtr, Xte, ytr, _ = JP.train_test_split(X, y)
    jm, tm = _fit_pair("linear_regression", Xtr, ytr)
    np.testing.assert_allclose(tm.predict(Xte).numpy(),
                               np.asarray(jm.predict(Xte)), rtol=1e-5,
                               atol=1e-5)


def test_linear_regression_on_exactly_collinear_columns():
    """The 1e-6 ridge vanishes in float32 beside a diagonal of ~n: JAX's LU
    meets a zero pivot and returns NaN; the port solves the ridge in
    float64, where it holds: the minimum-norm least-squares fit (float64
    ``pinv``) to 1e-4."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(200, 5))
    X = np.concatenate([X, X[:, :2]], 1)          # two duplicated columns
    y = 2 * X[:, 0] + X[:, 3]
    assert np.isnan(np.asarray(JP.LinearRegression().fit(X, y).w)).all()
    m = TP.LinearRegression(device=CPU).fit(X, y)
    Xs = (X - X.mean(0)) / X.std(0)
    np.testing.assert_allclose(m.w.numpy(), np.linalg.pinv(Xs) @ (y - y.mean()),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(m.predict(X).numpy(), y, rtol=0, atol=1e-4)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_linear_regression_does_not_follow_row_order(seed, table3):
    """Table-III data leave the float32 ridge singular, so a float32 fit's
    predictions follow the order of the training rows (the order of a sum,
    which is what differs between the card's reductions and the CPU's): a
    float32 LU fit on a permutation of these rows predicted up to 157x its
    unpermuted values.  The port's fit, in float64, holds them to 1e-4."""
    Xtr, Xte, ytr, _ = table3
    want = TP.LinearRegression(device=CPU).fit(Xtr, ytr).predict(Xte).numpy()
    p = np.random.default_rng(seed).permutation(len(ytr))
    got = TP.LinearRegression(device=CPU).fit(Xtr[p], ytr[p]).predict(Xte)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_xgb_grows_jax_trees(table3):
    Xtr, Xte, ytr, _ = table3
    jm, tm = _fit_pair("xgb", Xtr, ytr)
    for k in ("feature", "left", "right", "threshold"):
        np.testing.assert_array_equal(tm.forest[k].numpy(),
                                      np.asarray(jm.forest[k]), err_msg=k)
    np.testing.assert_allclose(tm.forest["value"].numpy(),
                               np.asarray(jm.forest["value"]), rtol=1e-6)
    assert tm.base == jm.base
    np.testing.assert_allclose(tm.predict(Xte).numpy(),
                               np.asarray(jm.predict(Xte)), rtol=1e-5)


@pytest.mark.parametrize("name", ["svm", "mlp"])
def test_params_after_ten_steps_match_jax(name, table3):
    Xtr, _, ytr, _ = table3
    jm, tm = _fit_pair(name, Xtr, ytr, steps=10)
    if name == "svm":
        pairs = [(tm.w, jm.w), (tm.b, jm.b)]
    else:
        pairs = [(tp, jp[k]) for jp, lw, lb in
                 zip(jm.params, tm.model.w, tm.model.b)
                 for k, tp in (("w", lw), ("b", lb))]
    for got, want in pairs:
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", ["svm", "mlp"])
def test_full_training_table2_metrics_within_one_percent(name, table3):
    Xtr, Xte, ytr, yte = table3
    jm, tm = _fit_pair(name, Xtr, ytr)
    want = JP.evaluate(yte, jm.predict(Xte))
    got = TP.evaluate(yte, tm.predict(Xte))
    for k in ("mae", "r2"):
        assert got[k] == pytest.approx(want[k], rel=1e-2), k


def _jax_svr_loss(params, Z, y, epsilon, C):
    # the loss inside repro.core.predictors.svm._train
    w, b = params
    err = jnp.abs(Z @ w + b - y) - epsilon
    return C * jnp.maximum(err, 0.0).mean() + 0.5 * (w @ w)


def test_svr_subgradients_at_the_kinks_match_jax_grad():
    """|e| == eps (jnp.maximum splits a tie 0.5/0.5) and e == 0 (jnp.abs
    gives 0): the hand-written gradient is jax.grad's."""
    Z = np.eye(4, 3, dtype=np.float32) + 0.25
    w = np.array([0.5, -0.25, 0.0], np.float32)
    b = np.float32(0.125)
    pred = Z @ w + b
    eps = np.float32(0.5)
    # rows: exactly on the eps kink (above and below), exactly zero error,
    # and a plain outlier
    y = pred - np.array([eps, -eps, 0.0, 2.0], np.float32)
    want = jax.grad(_jax_svr_loss)((jnp.asarray(w), jnp.asarray(b)), Z, y,
                                   float(eps), 10.0)
    gw, gb = tsvm.loss_grad(torch.as_tensor(Z), torch.as_tensor(y),
                            torch.as_tensor(w), torch.as_tensor(b),
                            float(eps), 10.0)
    np.testing.assert_allclose(gw.numpy(), np.asarray(want[0]), rtol=1e-6)
    assert float(gb) == pytest.approx(float(want[1]), rel=1e-6)


@pytest.mark.parametrize("name", ["linear_regression", "svm", "mlp", "xgb",
                                  "random_forest"])
def test_converted_predictor_predicts_as_jax(name, table3):
    Xtr, Xte, ytr, _ = table3
    kw = {"steps": 50} if name in ("svm", "mlp") else {}
    jm = JP.ALL_MODELS[name](**kw).fit(Xtr, ytr)
    tm = predictor_from_numpy(jm, device=CPU)
    assert type(tm) is TP.ALL_MODELS[name]
    np.testing.assert_allclose(tm.predict(Xte).numpy(),
                               np.asarray(jm.predict(Xte)), rtol=1e-5,
                               atol=1e-3)


def test_own_generator_is_seeded_and_deterministic(table3):
    Xtr, Xte, ytr, _ = table3
    for name in ("svm", "mlp"):
        a = TP.ALL_MODELS[name](steps=20, device=CPU).fit(Xtr, ytr)
        b = TP.ALL_MODELS[name](steps=20, device=CPU).fit(Xtr, ytr)
        c = TP.ALL_MODELS[name](steps=20, seed=1, device=CPU).fit(Xtr, ytr)
        torch.testing.assert_close(a.predict(Xte), b.predict(Xte),
                                   rtol=0, atol=0)
        assert not torch.equal(a.predict(Xte), c.predict(Xte))


@pytest.mark.parametrize("name", list(JP.ALL_MODELS))
def test_models_default_to_the_card(name):
    """``device=None`` is the CUDA card: without one the model refuses
    rather than carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TP.ALL_MODELS[name]()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TRM.ResourcePredictor()


# ---------------- the cases of tests/test_predictors.py, on the port ----

def test_linear_recovers_linear():
    X, y = _linear_data()
    Xtr, Xte, ytr, yte = TP.train_test_split(X, y)
    m = TP.LinearRegression(device=CPU).fit(Xtr, ytr)
    assert TP.evaluate(yte, m.predict(Xte))["r2"] > 0.99


@pytest.mark.parametrize("name", list(TP.ALL_MODELS))
def test_all_models_fit_nonlinear(name):
    X, y = _nonlinear_data()
    Xtr, Xte, ytr, yte = TP.train_test_split(X, y)
    kwargs = {}
    if name == "mlp":
        kwargs = {"steps": 1500}
    elif name == "svm":
        kwargs = {"steps": 4000, "C": 100.0, "n_features": 2048,
                  "epsilon": 0.001}
    m = TP.ALL_MODELS[name](**kwargs, device=CPU).fit(Xtr, ytr)
    r2 = TP.evaluate(yte, m.predict(Xte))["r2"]
    floor = {"linear_regression": 0.25, "svm": 0.5}.get(name, 0.7)
    assert r2 > floor, f"{name}: r2={r2}"


def test_trees_beat_linear_on_nonlinear():
    X, y = _nonlinear_data(seed=3)
    Xtr, Xte, ytr, yte = TP.train_test_split(X, y, seed=3)

    def r2(model):
        return TP.evaluate(yte, model.fit(Xtr, ytr).predict(Xte))["r2"]

    lr = r2(TP.LinearRegression(device=CPU))
    rf = r2(TP.RandomForestRegressor(seed=3, device=CPU))
    xgb = r2(TP.XGBRegressor(seed=3, device=CPU))
    assert rf > lr and xgb > lr


def test_forest_prediction_is_deterministic():
    X, y = _nonlinear_data(n=200)
    m = TP.RandomForestRegressor(n_estimators=10, seed=0,
                                 device=CPU).fit(X, y)
    assert torch.equal(m.predict(X[:10]), m.predict(X[:10]))


def test_evaluate_metrics():
    y = np.array([1.0, 2.0, 3.0])
    e = TP.evaluate(y, torch.tensor(y))
    assert e["mae"] == 0 and e["mse"] == 0 and e["r2"] == 1.0
    assert e == JP.evaluate(y, y)


def test_model_configs_match_jax():
    """Each port model keeps JAX's constructor defaults."""
    import inspect

    for name, jcls in JP.ALL_MODELS.items():
        want = {k: p.default for k, p in
                inspect.signature(jcls).parameters.items()}
        got = {k: p.default for k, p in
               inspect.signature(TP.ALL_MODELS[name]).parameters.items()
               if k != "device"}
        assert got == want, name
    assert dataclasses.is_dataclass(TRM.LinearFit)
