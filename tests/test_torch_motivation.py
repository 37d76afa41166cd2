"""The port's Table I motivation study against ``repro.cluster.motivation``,
with JAX's tick draws injected (``test_torch_noise.jax_noise_stream``), then
the paper's claim on the port's own generator."""
import numpy as np
import pytest
import torch

from repro.cluster import motivation as jmot
from repro_torch.cluster import motivation as tmot
from test_torch_noise import jax_noise_stream


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the module's tests: under the suite's
    several worker processes, torch's default of one thread a core in each
    makes their small CPU kernels spin against each other, and alone on an
    8-core CPU the module took 23 s at one thread against 29 s at eight."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CPU = torch.device("cpu")


@pytest.mark.parametrize("qps,cores,seed", [(300.0, 2.0, 0), (300.0, 20.0, 9),
                                            (2000.0, 8.0, 109)])
def test_measure_matches_jax(qps, cores, seed):
    want = jmot._measure(qps, cores, seed=seed)
    got = tmot._measure(qps, cores, seed=seed, device=CPU,
                        noise=jax_noise_stream)
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_table1_matches_jax():
    """All 20 configurations of both experiments: cpu, runqlat and rt
    within rtol 1e-4, and so the four curve fits of Table I."""
    for exp, seed in ((jmot.experiment1, 0), (jmot.experiment2, 100)):
        texp = getattr(tmot, exp.__name__)
        np.testing.assert_allclose(
            texp(seed, device=CPU, noise=jax_noise_stream), exp(seed),
            rtol=1e-4)
    want = jmot.table1(0)
    got = tmot.table1(0, device=CPU, noise=jax_noise_stream)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)


def test_runqlat_tracks_response_time_better_than_cpu():
    """The paper's Table I claim, on the port's own generator: response
    time fits runqlat better than CPU utilisation in both experiments."""
    t = tmot.table1(1, device=CPU)
    for exp in ("exp1", "exp2"):
        mape_r, r2_r = t[f"{exp}_runqlat_resp"]
        mape_c, r2_c = t[f"{exp}_cpu_resp"]
        assert r2_r > r2_c and mape_r < mape_c, (exp, t)


def test_experiment_shapes_and_fit_quality():
    e = tmot.experiment2(100, device=CPU)
    assert e.shape == (10, 3) and np.isfinite(e).all()
    assert (e[:, 1] > 0).all() and (e[:, 2] > 0).all()
    x = np.linspace(1.0, 2.0, 8)
    mape, r2 = tmot.fit_quality(x, 3 * x**2 - x + 1)
    assert mape < 1e-9 and r2 == pytest.approx(1.0)
    assert tmot.fit_quality(x, 3 * x**2) == jmot.fit_quality(x, 3 * x**2)


def test_measure_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmot._measure(300.0, 8.0)
