"""The port's demos and metric-pipeline bench on the CPU:
``examples/torch_colocation_sim.py --selftest``, ``examples/
torch_serve_demo.py`` over the smoke config of every architecture it
serves (token prompts and a decode path: not qwen2-vl-72b, not
hubert-xlarge), and ``benchmarks/bench_torch_metric_pipeline.run``,
whose histograms, Eq. 1 and Eq. 2 are held against ``repro.core`` on the
same samples (counts exact, floats to rtol 1e-5)."""
import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import metric as jmetric
from repro.core.interference import node_interference as jintf
from repro_torch import configs as tconfigs

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _load(rel):
    path = ROOT / rel
    spec = importlib.util.spec_from_file_location(f"_demo_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_colocation_selftest_on_the_cpu(capsys):
    mod = _load("examples/torch_colocation_sim.py")
    assert mod.selftest(device="cpu") == 1
    assert "selftest: ok" in capsys.readouterr().out


SERVED = [a for a in tconfigs.ARCHS
          if tconfigs.get_smoke_config(a).causal
          and not tconfigs.get_smoke_config(a).embed_inputs]


@pytest.mark.parametrize("arch", SERVED)
def test_serve_demo_serves_every_ported_arch(arch, capsys):
    mod = _load("examples/torch_serve_demo.py")
    stats = mod.main(["--arch", arch, "--device", "cpu", "--requests", "6"])
    assert stats["finished"] == 6
    assert stats["runqlat_hist"].sum() == 6
    assert stats["arch"] == tconfigs.get_smoke_config(arch).name
    assert "[serve_demo] finished=6" in capsys.readouterr().out


def test_demos_need_a_card_unless_told_otherwise(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        _load("examples/torch_serve_demo.py").main(["--arch", "gemma3-4b"])
    with pytest.raises(RuntimeError):
        _load("examples/torch_colocation_sim.py").selftest()
    with pytest.raises(RuntimeError):
        _load("benchmarks/bench_torch_metric_pipeline.py").run()


def test_metric_pipeline_bench_matches_jax_on_the_cpu():
    out = _load("benchmarks/bench_torch_metric_pipeline.py").run(device="cpu")
    names = [r[0] for r in out["rows"]]
    assert names == ["metric.histogram_cluster_tick",
                     "metric.node_interference_eq1", "metric.avg_runqlat_eq2"]
    assert all(r[1] > 0 for r in out["rows"])
    assert out["nodes"] == 1000 and out["samples"] == 1000 * 14 * 256
    assert out["binned"] == out["samples"]
    s = jnp.asarray(out["input"].numpy())
    h = jmetric.histogram(s)
    np.testing.assert_array_equal(out["hist"].numpy(), np.asarray(h))
    np.testing.assert_allclose(out["intf"].numpy(),
                               np.asarray(jintf(h[:, :8], h[:, 8:])),
                               rtol=1e-5)
    np.testing.assert_allclose(out["avg"].numpy(),
                               np.asarray(jmetric.avg_runqlat(h)), rtol=1e-5)
