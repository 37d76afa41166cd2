"""The port's one-device pipeline schedule, training launcher and
training example: ``gpipe_forward`` against sequential application (and
JAX's sequential reference, as ``tests/test_pipeline.py`` holds JAX's
pipeline), ``python -m repro_torch.launch.train`` training, checkpointing
and resuming on the CPU, and ``examples/torch_train_100m.py``."""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.train.pipeline import gpipe_forward

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _two_threads():
    """Two intra-op threads a test: the suite runs in several worker
    processes, and torch's default of one thread a core in each makes the
    small CPU kernels of a train step spin against each other (a 20-step
    run took 40 times as long under six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------- pipeline --

@pytest.mark.parametrize("n_stages", [1, 2, 4])
def test_gpipe_matches_sequential(n_stages):
    """As ``tests/test_pipeline.py``: 8 layers, 6 microbatches; the skewed
    schedule over ``n_stages`` stages equals applying the layers in order,
    and equals JAX's sequential reference on the same numpy weights."""
    L, M, Bm, D = 8, 6, 2, 16
    rng = np.random.default_rng(0)
    w = rng.standard_normal((L, D, D)).astype(np.float32) * (0.5 / D**0.5)
    b = rng.standard_normal((L, D)).astype(np.float32) * 0.1
    x = rng.standard_normal((M, Bm, D)).astype(np.float32)
    params = {"w": torch.from_numpy(w), "b": torch.from_numpy(b)}

    def apply_layer(lp, h):
        return torch.tanh(h @ lp["w"] + lp["b"])

    out = gpipe_forward(apply_layer, params, torch.from_numpy(x),
                        n_stages=n_stages)
    ref = []
    for m in range(M):
        h = torch.from_numpy(x[m])
        for i in range(L):
            h = apply_layer({"w": params["w"][i], "b": params["b"][i]}, h)
        ref.append(h)
    torch.testing.assert_close(out, torch.stack(ref), rtol=0, atol=0)
    jref = []
    for m in range(M):
        h = jnp.asarray(x[m])
        for i in range(L):
            h = jnp.tanh(h @ w[i] + b[i])
        jref.append(h)
    np.testing.assert_allclose(out.numpy(), np.stack(jref), rtol=1e-5,
                               atol=1e-6)
    with pytest.raises(ValueError):
        gpipe_forward(apply_layer, params, torch.from_numpy(x), n_stages=3)


# -------------------------------------------------- launcher and example --

def _run(args, tmp_path):
    """A child Python with two intra-op threads (see ``_two_threads``)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               TMPDIR=str(tmp_path), OMP_NUM_THREADS="2")
    return subprocess.run([sys.executable, *args], capture_output=True,
                          text=True, cwd=REPO, env=env, timeout=300)


def test_launcher_trains_checkpoints_and_resumes(tmp_path):
    ck = str(tmp_path / "ck")
    args = ["-m", "repro_torch.launch.train", "--arch", "smollm-135m",
            "--smoke", "--steps", "4", "--batch", "4", "--seq", "32",
            "--device", "cpu", "--ckpt-dir", ck, "--ckpt-every", "2",
            "--accum", "2", "--compress"]
    first = _run(args, tmp_path)
    assert first.returncode == 0, first.stderr[-2000:]
    assert "step=3" in first.stdout and "last-1 loss=" in first.stdout
    assert sorted(os.listdir(ck)) == ["LATEST", "step_2", "step_4"]
    again = _run([*args[:6], "6", *args[7:], "--resume"], tmp_path)
    assert again.returncode == 0, again.stderr[-2000:]
    assert "resumed from step 4" in again.stdout
    assert "step=5" in again.stdout and "step=3" not in again.stdout


def test_example_trains_on_cpu(tmp_path):
    out = _run([os.path.join(REPO, "examples", "torch_train_100m.py"),
                "--steps", "2", "--device", "cpu"], tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "smollm-135m-w256" in out.stdout
    assert "[example] loss:" in out.stdout
    assert os.path.isdir(tmp_path / "repro_torch_ckpt_100m" / "step_2")
