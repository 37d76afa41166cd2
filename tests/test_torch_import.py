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
