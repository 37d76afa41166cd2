"""The port's checkpointing (``repro_torch.train.checkpoint``) and fault
tolerance (``repro_torch.train.fault``): the six behaviours of
``tests/test_checkpoint.py`` and the five of ``tests/test_fault.py`` under
the same names, plus JAX's layout read both ways (a checkpoint written by
JAX's ``Checkpointer`` restores into the port, and the port's into JAX's),
bfloat16 leaves, and a model's training state."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train.checkpoint import Checkpointer as JCheckpointer
from repro.train.fault import StragglerDetector as JStragglerDetector
from repro.train.fault import StragglerPolicy as JStragglerPolicy
from repro_torch.configs import get_smoke_config
from repro_torch.models.model import Model
from repro_torch.train import init_train_state
from repro_torch.train.checkpoint import Checkpointer
from repro_torch.train.fault import (
    Preemptible,
    StragglerDetector,
    StragglerPolicy,
    run_with_restarts,
)


def _tree(x=1.0):
    return {
        "params": {"w": torch.full((4, 4), x), "b": torch.zeros((4,))},
        "opt": {"m": torch.full((4, 4), x / 2), "step": 7},
    }


def test_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(10, _tree(3.0))
    restored, step = ck.restore(_tree(0.0))
    assert step == 10
    torch.testing.assert_close(restored["params"]["w"],
                               torch.full((4, 4), 3.0))
    assert restored["opt"]["step"] == 7


def test_latest_pointer_and_gc(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, _tree(float(s)))
    assert ck.latest_step() == 4
    assert sorted(ck.all_steps()) == [3, 4]
    restored, step = ck.restore(_tree(0.0))
    assert step == 4
    torch.testing.assert_close(restored["params"]["w"],
                               torch.full((4, 4), 4.0))


def test_async_save(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(5, _tree(5.0), async_=True)
    ck.wait()
    restored, step = ck.restore(_tree(0.0))
    assert step == 5


def test_no_partial_checkpoint_visible(tmp_path):
    """A crashed write (leftover .tmp) must not be restorable."""
    ck = Checkpointer(str(tmp_path))
    ck.save(1, _tree(1.0))
    os.makedirs(os.path.join(str(tmp_path), "step_2.tmp"))
    assert ck.latest_step() == 1
    assert sorted(ck.all_steps()) == [1]


def test_shape_mismatch_rejected(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, _tree())
    bad = {"params": {"w": torch.zeros((2, 2)), "b": torch.zeros((4,))},
           "opt": {"m": torch.zeros((4, 4)), "step": 0}}
    with pytest.raises(ValueError, match="params/w"):
        ck.restore(bad)


def test_elastic_restore_new_sharding(tmp_path):
    """The one-card form of JAX's elastic restore: tensors land on the
    device asked for (here the CPU, named), in the template's dtypes,
    whatever device and dtype wrote them."""
    ck = Checkpointer(str(tmp_path))
    tree = _tree(2.0)
    tree["params"]["w"] = tree["params"]["w"].to(torch.bfloat16)
    ck.save(3, tree)
    template = _tree(0.0)
    template["params"]["w"] = template["params"]["w"].double()
    restored, step = ck.restore(template, device=torch.device("cpu"))
    assert step == 3
    assert restored["params"]["w"].dtype == torch.float64
    assert restored["params"]["w"].device.type == "cpu"
    torch.testing.assert_close(restored["params"]["w"],
                               torch.full((4, 4), 2.0, dtype=torch.float64))


def test_async_then_final_save_of_one_step_do_not_race(tmp_path):
    """The launcher saves step N asynchronously and again at the end;
    every save waits for the write before it."""
    ck = Checkpointer(str(tmp_path))
    for _ in range(5):
        ck.save(6, _tree(6.0), async_=True)
        ck.save(6, _tree(6.5))
    restored, step = ck.restore(_tree(0.0))
    torch.testing.assert_close(restored["params"]["w"],
                               torch.full((4, 4), 6.5))


def test_reads_jax_checkpoints_and_jax_reads_the_ports(tmp_path):
    """JAX's layout both ways: the port restores what JAX's Checkpointer
    wrote (same keys, manifest and LATEST), and JAX's restores what the
    port wrote; bfloat16 leaves exactly."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((4, 4)).astype(np.float32)
    jtree = {"params": {"w": jnp.asarray(w).astype(jnp.bfloat16),
                        "b": jnp.zeros((4,))},
             "opt": {"m": jnp.asarray(w), "step": jnp.int32(9)}}
    JCheckpointer(str(tmp_path / "jax")).save(9, jtree)
    template = {"params": {"w": torch.zeros((4, 4), dtype=torch.bfloat16),
                           "b": torch.zeros((4,))},
                "opt": {"m": torch.zeros((4, 4)), "step": 0}}
    restored, step = Checkpointer(str(tmp_path / "jax")).restore(template)
    assert step == 9 and restored["opt"]["step"] == 9
    np.testing.assert_array_equal(restored["opt"]["m"].numpy(), w)
    np.testing.assert_array_equal(
        restored["params"]["w"].float().numpy(),
        np.asarray(jtree["params"]["w"].astype(jnp.float32)))
    Checkpointer(str(tmp_path / "port")).save(9, restored)
    back, step = JCheckpointer(str(tmp_path / "port")).restore(
        {"params": {"w": np.zeros((4, 4)), "b": np.zeros((4,))},
         "opt": {"m": np.zeros((4, 4)), "step": np.int32(0)}})
    assert step == 9 and int(back["opt"]["step"]) == 9
    np.testing.assert_array_equal(np.asarray(back["opt"]["m"]), w)


def test_model_training_state_round_trips(tmp_path):
    """A smoke model's parameters (bf16) and AdamW state with the
    compressor's error restore bit for bit into a fresh model's."""
    cfg = get_smoke_config("smollm-135m")
    model, opt = init_train_state(Model(cfg, device="cpu"),
                                  torch.Generator().manual_seed(0),
                                  compress=True)
    opt["step"] = 3
    ck = Checkpointer(str(tmp_path))
    ck.save(3, {"params": dict(model.named_parameters()), "opt": opt})
    fresh, fopt = init_train_state(Model(cfg, device="cpu"),
                                   torch.Generator().manual_seed(1),
                                   compress=True)
    restored, step = ck.restore({"params": dict(fresh.named_parameters()),
                                 "opt": fopt})
    assert step == 3 and restored["opt"]["step"] == 3
    for n, p in model.named_parameters():
        assert restored["params"][n].dtype == p.dtype
        assert torch.equal(restored["params"][n], p.detach())
    for key in ("master", "m", "v", "comp_err"):
        for n, t in opt[key].items():
            assert torch.equal(restored["opt"][key][n], t)


# ---------------------------------------------------------------- fault --

def test_straggler_flags_outlier():
    d = StragglerDetector(StragglerPolicy(min_samples=3, deadline_factor=3.0))
    for _ in range(5):
        assert not d.observe(1.0)["straggler"]
    assert d.observe(10.0)["straggler"]


def test_straggler_eviction_after_repeat_offenses():
    d = StragglerDetector(StragglerPolicy(min_samples=2, evict_after=2))
    for _ in range(3):
        d.observe(1.0)
    first = d.observe(20.0)
    second = d.observe(20.0)
    assert first["straggler"] and not first["evict"]
    assert second["evict"]


def test_straggler_robust_ewma_not_poisoned():
    d = StragglerDetector(StragglerPolicy(min_samples=2))
    for _ in range(4):
        d.observe(1.0)
    d.observe(100.0)  # one massive outlier
    assert d.ewma < 2.0  # clipped update
    assert d.observe(1.0)["straggler"] is False


def test_straggler_detector_equals_jax_on_a_trace():
    """Every verdict and the EWMA after every sample equal JAX's."""
    rng = np.random.default_rng(0)
    trace = list(np.where(rng.random(200) < 0.1, 8.0, 1.0)
                 * rng.uniform(0.8, 1.2, 200))
    pol = dict(min_samples=4, evict_after=2, deadline_factor=2.5)
    d, jd = StragglerDetector(StragglerPolicy(**pol)), JStragglerDetector(
        JStragglerPolicy(**pol))
    for x in trace:
        assert d.observe(float(x)) == jd.observe(float(x))
        assert d.ewma == jd.ewma and d.violations == jd.violations


def test_run_with_restarts_resumes_from_checkpoint(tmp_path):
    ck = Checkpointer(str(tmp_path))
    attempts = []

    def train_loop(state):
        start = 0
        if state == "RESTORE":
            restored, step = ck.restore({"step": 0})
            start = int(restored["step"]) + 1
        attempts.append(start)
        for step in range(start, 10):
            ck.save(0, {"step": step})  # overwrite step 0 slot with progress
            if step == 4 and len(attempts) == 1:
                raise Preemptible("node lost")
        return "done"

    result, restarts = run_with_restarts(train_loop, ck)
    assert result == "done"
    assert restarts == 1
    assert attempts == [0, 5]  # resumed after the last checkpointed step


def test_run_with_restarts_gives_up(tmp_path):
    ck = Checkpointer(str(tmp_path))

    def always_dies(state):
        raise Preemptible()

    with pytest.raises(Preemptible):
        run_with_restarts(always_dies, ck, max_restarts=2)
