"""The port's runqlat metric against ``repro.core.metric`` and the Pallas
kernel, on the same numpy-made inputs (CPU: the wrapper's plain version)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import metric as jmetric
from repro.kernels import ref
from repro.kernels.runqlat_hist import runqlat_hist_pallas
from repro_torch.core import metric as tmetric
from repro_torch.kernels import runqlat_hist as K

RTOL = 1e-6


def _samples(S, N, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(-10, 1200, (S, N)).astype(np.float32)


def _all_equal(s, w=None):
    """Port histogram; assert it equals metric.histogram, the Pallas kernel
    (interpret mode) and the ref oracle bit for bit."""
    got = tmetric.histogram(torch.from_numpy(s),
                            None if w is None else torch.from_numpy(w)).numpy()
    jw = None if w is None else jnp.asarray(w)
    for want in (jmetric.histogram(jnp.asarray(s), jw),
                 runqlat_hist_pallas(jnp.asarray(s), jw, interpret=True),
                 ref.runqlat_hist_ref(s, jw)):
        np.testing.assert_array_equal(got, np.asarray(want))
    return got


@pytest.mark.parametrize("S,N", [(1, 100), (4, 1000), (3, 513)])
def test_histogram_equals_jax_on_kernel_sweep(S, N):
    got = _all_equal(_samples(S, N))
    assert np.all(got.sum(-1) == N)


def test_histogram_main_path_shape_with_mask():
    """(nodes * S_ON, 16) series with 0/1 weights, as ``_tick`` bins them."""
    rng = np.random.default_rng(1)
    s = (rng.gamma(2.0, 40.0, (12 * 8, 16))).astype(np.float32)
    w = np.repeat(rng.random((12 * 8, 1)) < 0.6, 16, axis=1).astype(np.float32)
    got = _all_equal(s, w)
    np.testing.assert_array_equal(got.sum(-1), w.sum(-1))


def test_histogram_bin_edges_exact():
    """Samples one ulp either side of every edge bin as IEEE s / 5 does."""
    edges = np.arange(201, dtype=np.float32) * 5.0
    s = np.stack([np.nextafter(edges, -np.inf), edges,
                  np.nextafter(edges, np.inf)]).astype(np.float32)
    _all_equal(s)


def test_histogram_leading_dims_and_zero_weight_padding():
    s = np.asarray([[[1.0, 10.0, 700.0, 0.0], [3.0, 3.0, 3.0, 3.0]]],
                   np.float32)
    w = np.asarray([[[1.0, 1.0, 1.0, 0.0], [0.0, 0.0, 0.0, 0.0]]], np.float32)
    got = tmetric.histogram(torch.from_numpy(s), torch.from_numpy(w))
    assert got.shape == (1, 2, 200)
    assert float(got[0, 0].sum()) == 3.0 and float(got[0, 1].sum()) == 0.0
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jmetric.histogram(jnp.asarray(s),
                                                  jnp.asarray(w))))


def test_histogram_general_weights_close():
    rng = np.random.default_rng(2)
    s = _samples(5, 300, seed=3)
    w = (rng.random((5, 300)) * (rng.random((5, 300)) < 0.8)).astype(np.float32)
    got = tmetric.histogram(torch.from_numpy(s), torch.from_numpy(w)).numpy()
    want = np.asarray(jmetric.histogram(jnp.asarray(s), jnp.asarray(w)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6)


def test_wrapper_checks_and_cpu_route():
    before = K.launches
    s = torch.from_numpy(_samples(2, 10))
    with pytest.raises(ValueError):
        K.runqlat_hist(s.double())
    with pytest.raises(ValueError):
        K.runqlat_hist(s.t())                      # not contiguous
    with pytest.raises(ValueError):
        K.runqlat_hist(s, torch.ones(2, 9))        # weight shape
    torch.testing.assert_close(K.runqlat_hist(s), K.runqlat_hist_plain(s),
                               rtol=0, atol=0)
    assert K.launches == before  # the CPU route launches no kernel


def _hists(seed=4, shape=(3, 6)):
    rng = np.random.default_rng(seed)
    h = rng.poisson(3.0, (*shape, 200)).astype(np.float32)
    h[0, 0] = 0.0  # an empty histogram
    return h


def test_avg_percentile_merge_match_jax():
    h = _hists()
    th, jh = torch.from_numpy(h), jnp.asarray(h)
    np.testing.assert_allclose(tmetric.avg_runqlat(th).numpy(),
                               np.asarray(jmetric.avg_runqlat(jh)), rtol=RTOL)
    assert float(tmetric.avg_runqlat(th)[0, 0]) == 0.0
    for q in (0.0, 50.0, 90.0, 99.0, 100.0):
        np.testing.assert_allclose(tmetric.percentile(th, q).numpy(),
                                   np.asarray(jmetric.percentile(jh, q)),
                                   rtol=RTOL)
    h2 = _hists(seed=5)
    np.testing.assert_allclose(
        tmetric.merge(th, torch.from_numpy(h2), th).numpy(),
        np.asarray(jmetric.merge(jh, jnp.asarray(h2), jh)), rtol=RTOL)


def test_collector_matches_jax():
    rng = np.random.default_rng(6)
    t, j = tmetric.RunqlatCollector(), jmetric.RunqlatCollector()
    for _ in range(3):
        batch = rng.uniform(-5, 1100, 50)
        t.add(batch)
        j.add(batch)
    np.testing.assert_array_equal(t.snapshot(), j.snapshot())
    assert t.count == j.count == 150
    assert t.average() == pytest.approx(j.average(), rel=RTOL)
    t.reset()
    assert t.count == 0 and t.hist.sum() == 0


def test_sample_from_hist_moments():
    """Distribution parity: the drawn samples' mean and spread match the
    histogram's (JAX's draws cannot be reproduced, so compare moments)."""
    import jax

    h = np.zeros(200, np.float32)
    h[[2, 10, 11, 40]] = [5.0, 20.0, 10.0, 5.0]
    centers = np.arange(200) * 5.0 + 2.5
    p = h / h.sum()
    mean = float((p * centers).sum())
    var = float((p * (centers - mean) ** 2).sum()) + 25.0 / 12.0
    n = 20_000
    g = torch.Generator().manual_seed(0)
    ts = tmetric.sample_from_hist(torch.from_numpy(h), g, n).numpy()
    js = np.asarray(jmetric.sample_from_hist(jnp.asarray(h),
                                             jax.random.PRNGKey(0), n))
    se = np.sqrt(var / n)
    for s in (ts, js):
        assert abs(s.mean() - mean) < 4 * se
        assert s.std() == pytest.approx(np.sqrt(var), rel=0.03)
    assert abs(ts.mean() - js.mean()) < 4 * np.sqrt(2) * se
    # every draw lands in a populated bin
    assert set(np.unique(np.floor(ts / 5.0).astype(int))) <= {2, 10, 11, 40}
