"""The port's CUDA kernel and device path against their plain versions.

Only torch and ``repro_torch`` are imported here (no JAX), so this file
runs on a machine with a card: ``python -m pytest -m cuda
tests/test_torch_cuda.py``.  Without a card the ``cuda`` tests skip.
"""
import shutil

import numpy as np
import pytest
import torch

from repro_torch.cluster import state as tstate
from repro_torch.cluster.fleet import make_fleet
from repro_torch.cluster.simulator import Cluster
from repro_torch.cluster.workloads import Pod
from repro_torch.kernels import build
from repro_torch.kernels import runqlat_hist as K


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _inputs(S, N, seed, device, zero_one=True):
    g = torch.Generator().manual_seed(seed)
    s = torch.rand((S, N), generator=g) * 1210.0 - 10.0
    if zero_one:
        w = (torch.rand((S, 1), generator=g) < 0.6).float().expand(S, N)
    else:
        w = torch.rand((S, N), generator=g) * (torch.rand((S, N), generator=g) < 0.8)
    return s.to(device), w.contiguous().to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [8000, 6000])
def test_kernel_equals_plain_at_main_path_shapes(card, S):
    s, w = _inputs(S, 16, S, card)
    before = K.launches
    got = K.runqlat_hist(s, w)
    torch.cuda.synchronize()
    assert K.launches == before + 1
    torch.testing.assert_close(got, K.runqlat_hist_plain(s, w), rtol=0, atol=0)
    torch.testing.assert_close(got.sum(-1), w.sum(-1), rtol=0, atol=0)
    torch.testing.assert_close(K.runqlat_hist(s), K.runqlat_hist_plain(s),
                               rtol=0, atol=0)


@pytest.mark.cuda
def test_kernel_ragged_float_weights(card):
    """General float weights: the atomics add in no fixed order, so the
    result agrees to float32 rounding, not bit for bit."""
    s, w = _inputs(64, 5003, 1, card, zero_one=False)
    torch.testing.assert_close(K.runqlat_hist(s, w), K.runqlat_hist_plain(s, w),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
def test_cuda_tensor_never_takes_the_plain_version(card, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("plain version called for a CUDA tensor")

    s, w = _inputs(10, 16, 2, card)
    monkeypatch.setattr(K, "runqlat_hist_plain", refuse)
    K.runqlat_hist(s, w)
    with pytest.raises(ValueError):
        K.runqlat_hist(s, w.cpu())                 # mixed devices


@pytest.mark.cuda
def test_ticks_on_card_match_cpu_with_the_same_noise(card):
    c = Cluster(fleet=make_fleet(40, seed=0), seed=0, device=card)
    rng = np.random.default_rng(0)
    for i in range(60):
        pod = Pod("web_search", float(rng.uniform(50, 900)), True)
        if i % 3 == 0:
            pod = Pod("graph_analytics", 0.0, False, duration=int(rng.integers(3, 30)))
            pod.cpu_demand = 4.0
        c.place(pod, i % 40)
    gen = torch.Generator(device=card).manual_seed(1)
    noise = tstate.draw_noise(gen, c.n, 10)
    cpu = torch.device("cpu")

    def on(dev, tree):
        return {k: v.to(dev) for k, v in tree.items()}

    gst, gout = tstate._window_core(c.state, c.profiles, c.fleet_params, 50.0,
                                    noise)
    cst, cout = tstate._window_core(
        tstate.ClusterState(**on(cpu, vars(c.state))),
        on(cpu, c.profiles),
        tstate.FleetParams(**on(cpu, vars(c.fleet_params))), 50.0,
        [tstate.TickNoise(**on(cpu, vars(n))) for n in noise])
    for k, v in vars(gst).items():
        torch.testing.assert_close(v.cpu(), getattr(cst, k), rtol=0, atol=0)
    for k, v in gout.items():
        if k.startswith("hist"):
            torch.testing.assert_close(v.sum(-1).cpu(), cout[k].sum(-1),
                                       rtol=0, atol=0)
        else:
            torch.testing.assert_close(v.cpu(), cout[k], rtol=1e-5, atol=1e-5)


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    """No compiler means an error, never a quiet fallback."""
    if shutil.which("nvcc") or torch.cuda.is_available():
        pytest.skip("a CUDA toolchain is present")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(build, "_loaded", {})
    with pytest.raises(RuntimeError, match="nvcc"):
        build.load("runqlat_hist")
