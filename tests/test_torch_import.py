"""The port stands alone: importing every ``repro_torch`` module loads
neither ``jax`` nor any module of the JAX package ``repro``."""
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")


def _port_modules():
    out = []
    root = os.path.join(SRC, "repro_torch")
    for dirpath, _, files in os.walk(root):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), SRC)[:-3]
                mod = rel.replace(os.sep, ".")
                out.append(mod[: -len(".__init__")] if mod.endswith(
                    ".__init__") else mod)
    return sorted(out)


def test_every_port_module_imports_without_jax_or_repro():
    mods = _port_modules()
    assert "repro_torch.cluster.experiment" in mods
    assert "repro_torch.kernels.runqlat_hist" in mods
    for mod in ("repro_torch.kernels.rollout_tick",
                "repro_torch.control.detector",
                "repro_torch.control.forecast",
                "repro_torch.control.loop",
                "repro_torch.cluster.trace",
                "repro_torch.cluster.view",
                "repro_torch.obs.events",
                "repro_torch.obs.recorder",
                "repro_torch.obs.explain",
                "repro_torch.kernels.flash_attention",
                "repro_torch.kernels.ssd",
                "repro_torch.kernels.rwkv_wkv",
                "repro_torch.models.common",
                "repro_torch.models.attention",
                "repro_torch.models.ssd",
                "repro_torch.models.rwkv",
                "repro_torch.models.ffn",
                "repro_torch.models.blocks",
                "repro_torch.models.model",
                "repro_torch.configs",
                "repro_torch.configs.zamba2_1p2b",
                "repro_torch.configs.smollm_135m",
                "repro_torch.configs.rwkv6_7b",
                "repro_torch.serve",
                "repro_torch.serve.engine",
                "repro_torch.launch.serve",
                "repro_torch.data",
                "repro_torch.data.pipeline",
                "repro_torch.optim",
                "repro_torch.optim.adamw",
                "repro_torch.optim.compress",
                "repro_torch.optim.schedule",
                "repro_torch.train",
                "repro_torch.train.train_step",
                "repro_torch.train.checkpoint",
                "repro_torch.train.fault",
                "repro_torch.train.pipeline",
                "repro_torch.launch.train"):
        assert mod in mods, mod
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=REPO, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_port_sources_name_no_jax_or_repro_import():
    for mod in _port_modules():
        path = os.path.join(SRC, *mod.split("."))
        path = path + ".py" if os.path.exists(path + ".py") else os.path.join(
            path, "__init__.py")
        with open(path) as fh:
            for n, line in enumerate(fh, 1):
                s = line.strip()
                assert not s.startswith(("import jax", "from jax")), (path, n)
                assert not s.startswith(("import repro.", "from repro.",
                                         "from repro import")), (path, n)


BENCHES = os.path.join(REPO, "benchmarks")
PORT_BENCHES = ("bench_torch_schedulers", "bench_torch_scheduler_latency",
                "bench_torch_rollout_scale", "torch_run")


def test_port_benches_import_without_jax_or_repro():
    """The three main-path benches and the harness load neither ``jax``
    nor the JAX package, and name no import of either."""
    code = (
        "import importlib, sys\n"
        f"for m in {PORT_BENCHES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([SRC, BENCHES]))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=REPO, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")
    for name in PORT_BENCHES:
        with open(os.path.join(BENCHES, name + ".py")) as fh:
            for n, line in enumerate(fh, 1):
                s = line.strip()
                assert not s.startswith(("import jax", "from jax")), (name, n)
                assert not s.startswith(("import repro.", "from repro.",
                                         "from repro import",
                                         "import bench_schedulers",
                                         "import bench_rollout_scale",
                                         "import bench_scheduler_latency")), (
                    name, n)


def test_torch_run_selftest_passes():
    """``benchmarks/torch_run.py --selftest`` imports every port bench and
    finds a callable ``run`` in each."""
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run(
        [sys.executable, os.path.join(BENCHES, "torch_run.py"), "--selftest"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = proc.stdout.splitlines()
    for name in ("bench_torch_paper", "bench_torch_schedulers",
                 "bench_torch_control", "bench_torch_scheduler_latency",
                 "bench_torch_rollout_scale", "bench_torch_metric_pipeline"):
        assert f"{name}: ok" in lines, proc.stdout
    assert lines[-1] == "selftest: 6/6 modules ok"


def test_torch_run_adapts_the_metric_pipeline_call(monkeypatch):
    """The harness calls ``bench_torch_metric_pipeline.run(device=,
    full=)`` and prints the rows of the dict it returns; the other benches
    by ``run(fast=, device=)``."""
    monkeypatch.syspath_prepend(BENCHES)
    import importlib

    harness = importlib.import_module("torch_run")
    calls = []

    class Bench:
        def __init__(self, name):
            self.__name__ = name

        def run(self, **kw):
            calls.append((self.__name__, kw))
            if self.__name__ == "bench_torch_metric_pipeline":
                return {"rows": [("metric.x", 1.0, "d")], "hist": None}
            return [("torch.y", 2.0, "e")]

    assert harness.rows(Bench("bench_torch_metric_pipeline"), True,
                        "cpu") == [("metric.x", 1.0, "d")]
    assert harness.rows(Bench("bench_torch_schedulers"), False, "cpu") == [
        ("torch.y", 2.0, "e")]
    assert calls == [("bench_torch_metric_pipeline",
                      {"device": "cpu", "full": False}),
                     ("bench_torch_schedulers",
                      {"fast": False, "device": "cpu"})]
