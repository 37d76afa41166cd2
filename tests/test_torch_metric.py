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


def _main_path_sets(nodes=12, seed=7):
    """The two sets a tick bins: (nodes, 8) online and (nodes, 6) offline
    slots of 16 samples, 0/1 slot masks broadcast along the samples."""
    rng = np.random.default_rng(seed)
    sets = []
    for slots in (8, 6):
        s = rng.gamma(2.0, 60.0, (nodes, slots, 16)).astype(np.float32)
        m = (rng.random((nodes, slots)) < 0.6).astype(np.float32)
        sets.append((s, m))
    return sets


def test_histograms_one_call_equals_per_set_calls_and_pallas():
    """``metric.histograms`` with stride-0 mask weights equals one
    ``metric.histogram`` per set on materialised weights, JAX's
    ``metric.histogram`` and the Pallas kernel (interpret mode), bit for
    bit (0/1 weights)."""
    sets = _main_path_sets()
    torch_sets = [(torch.from_numpy(s),
                   torch.from_numpy(m)[..., None].expand(s.shape))
                  for s, m in sets]
    assert all(w.stride()[-1] == 0 for _, w in torch_sets)
    got = tmetric.histograms(*torch_sets)
    for h, (s, m) in zip(got, sets):
        w = np.broadcast_to(m[..., None], s.shape).copy()
        assert h.shape == (*s.shape[:-1], 200)
        np.testing.assert_array_equal(
            h.numpy(), tmetric.histogram(torch.from_numpy(s),
                                         torch.from_numpy(w)).numpy())
        np.testing.assert_array_equal(
            h.numpy(), np.asarray(jmetric.histogram(jnp.asarray(s),
                                                    jnp.asarray(w))))
        flat_s, flat_w = s.reshape(-1, 16), w.reshape(-1, 16)
        np.testing.assert_array_equal(
            h.numpy().reshape(-1, 200),
            np.asarray(runqlat_hist_pallas(jnp.asarray(flat_s),
                                           jnp.asarray(flat_w),
                                           interpret=True)))
        np.testing.assert_array_equal(h.numpy().sum(-1), w.sum(-1))


@pytest.mark.parametrize("weighted", [False, True])
def test_segments_entry_ragged_sets_match_jax(weighted):
    """Sets of other widths (n 1, 33 and 300; one with no series) through
    ``runqlat_hist_segments``, against JAX's ``metric.histogram``; float
    weights with zeros: the CPU route bins each set sequentially, as JAX's
    one-hot sum does not, so general weights agree to float32 rounding."""
    rng = np.random.default_rng(8)
    sets = []
    for S, N in ((5, 1), (7, 33), (0, 4), (3, 300)):
        s = rng.uniform(-10, 1200, (S, N)).astype(np.float32)
        w = (rng.random((S, N)) * (rng.random((S, N)) < 0.8)).astype(
            np.float32) if weighted else None
        sets.append((s, w))
    got = K.runqlat_hist_segments(
        [(torch.from_numpy(s), None if w is None else torch.from_numpy(w))
         for s, w in sets])
    assert [tuple(h.shape) for h in got] == [(5, 200), (7, 200), (0, 200),
                                             (3, 200)]
    for h, (s, w) in zip(got, sets):
        want = np.asarray(jmetric.histogram(
            jnp.asarray(s), None if w is None else jnp.asarray(w)))
        if weighted:
            np.testing.assert_allclose(h.numpy(), want, rtol=RTOL, atol=1e-6)
        else:
            np.testing.assert_array_equal(h.numpy(), want)


def test_segments_entry_checks_and_cpu_route():
    before = K.launches
    s = torch.from_numpy(_samples(4, 16))
    m = torch.ones(4, 1).expand(4, 16)
    with pytest.raises(ValueError):
        K.runqlat_hist_segments([])
    with pytest.raises(ValueError):
        K.runqlat_hist_segments([(s, m)] * (K.MAX_SEGMENTS + 1))
    with pytest.raises(ValueError):
        K.runqlat_hist_segments([(s, m), (s.double(), None)])
    with pytest.raises(ValueError):
        K.runqlat_hist_segments([(s, torch.ones(4, 15))])   # weight shape
    with pytest.raises(ValueError):
        K.runqlat_hist_segments([(s, m), (s[None], None)])  # not 2-D
    a, b = K.runqlat_hist_segments([(s, m), (s.t(), None)])  # any strides
    torch.testing.assert_close(a, K.runqlat_hist_plain(s), rtol=0, atol=0)
    torch.testing.assert_close(b, K.runqlat_hist_plain(s.t().contiguous()),
                               rtol=0, atol=0)
    assert K.launches == before  # the CPU route launches no kernel


def test_tick_bins_both_slot_kinds_in_one_call(monkeypatch):
    """``_tick`` hands both slot kinds to one ``metric.histograms`` call,
    with the slot masks broadcast (stride 0), and its histograms equal the
    two ``metric.histogram`` calls on materialised masks bit for bit."""
    from repro_torch.cluster.fleet import make_fleet
    from repro_torch.cluster.simulator import Cluster
    from repro_torch.cluster import state as tstate
    from repro_torch.cluster.workloads import Pod

    c = Cluster(fleet=make_fleet(6, seed=0), seed=0, device="cpu")
    for i in range(10):
        pod = Pod("web_search", 100.0 + 50 * i, True)
        if i % 3 == 0:
            pod = Pod("graph_analytics", 0.0, False, duration=9)
            pod.cpu_demand = 4.0
        c.place(pod, i % 6)
    calls = []
    real = tmetric.histograms

    def spy(*sets):
        calls.append(sets)
        return real(*sets)

    monkeypatch.setattr(tmetric, "histograms", spy)
    noise = tstate.draw_noise(torch.Generator().manual_seed(5), c.n, 1)[0]
    _, out = tstate._tick(c.state, c.profiles, c.fleet_params,
                          torch.tensor(30.0), noise)
    assert len(calls) == 1 and len(calls[0]) == 2
    for (s, w), key in zip(calls[0], ("hist_on", "hist_off")):
        assert w.stride()[-1] == 0
        want = tmetric.histogram(s, w.contiguous())
        torch.testing.assert_close(out[key], want, rtol=0, atol=0)
    assert float(out["hist_on"].sum()) > 0 and float(out["hist_off"].sum()) > 0
