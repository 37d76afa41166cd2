"""The port's training stack against the JAX package on the same inputs:
the models' ``train_loss`` and every gradient leaf against
``jax.value_and_grad`` of JAX's ``train_loss`` on the smoke configs in
float32, weights carried by ``model_params_from_numpy``;
``make_train_step`` against JAX's step (params, master, m, v, metrics),
with and without accumulation, compression and remat; the mirrored
``tests/test_train.py`` behaviours.  (The attention backward's parity is
in ``test_torch_train_attention.py``, the pipeline, launcher and example
in ``test_torch_train_launch.py``.)

Tolerances: the loss rtol 1e-5 (float32, the same arithmetic in another
order); gradients and optimizer state within 1e-4 of each leaf's largest
magnitude (sums over a batch of tokens in another order: a few float32
ulps of the largest term, amplified by nothing larger than the leaf).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.data import SyntheticLM as JSyntheticLM
from repro.models import model as JM
from repro.optim import AdamWConfig as JAdamWConfig
from repro.train import make_train_step as jmake_train_step
from repro.optim import init_opt_state as jinit_opt_state
from repro_torch import configs as tconfigs
from repro_torch.convert import (
    model_params_from_numpy,
    opt_state_from_numpy,
    params_to_numpy,
)
from repro_torch.data import SyntheticLM
from repro_torch.models import model as TM
from repro_torch.optim import AdamWConfig
from repro_torch.train import init_train_state, make_train_step
from repro_torch.train.train_step import batch_to_device

LOSS_RTOL = 1e-5
LEAF_TOL = 1e-4


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _check_tree(got: dict, want: dict, tol=LEAF_TOL, where=""):
    """Every leaf of JAX-layout trees within ``tol`` of its largest
    finite magnitude, with NaN exactly where JAX has NaN (JAX's own
    zamba2 gradients hold NaN, see ``test_loss_and_grads_match_jax``)."""
    if isinstance(want, dict):
        assert set(got) == set(want), (where, sorted(got), sorted(want))
        for k in want:
            _check_tree(got[k], want[k], tol, f"{where}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _check_tree(g, w, tol, f"{where}/{i}")
    else:
        g, w = np.asarray(got, np.float32), np.asarray(want, np.float32)
        assert g.shape == w.shape, where
        nan = np.isnan(w)
        assert (np.isnan(g) == nan).all(), (where, "NaN elsewhere than JAX")
        if not nan.all():
            assert _rel(g[~nan], w[~nan]) <= tol, (where,
                                                   _rel(g[~nan], w[~nan]))


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


# ------------------------------------------------------------ the models --

B, T = 4, 64


def _configs(arch):
    return (dataclasses.replace(jget_smoke(arch), dtype=jnp.float32),
            dataclasses.replace(tconfigs.get_smoke_config(arch),
                                dtype=torch.float32))


def _batch(jcfg, seed=0, masked=False, seq=T):
    """JAX's synthetic batch (numpy): tokens, or embeddings and M-RoPE
    positions; ``masked`` marks a random 40% of the frames as predicted
    (the encoder's masked-unit loss)."""
    ds = JSyntheticLM(jcfg.vocab_size, seq, B, seed=seed,
                      embed_dim=jcfg.d_model if jcfg.embed_inputs else 0,
                      mrope=bool(jcfg.mrope_sections))
    b = ds.batch(seed)
    if masked:
        rng = np.random.default_rng(seed + 100)
        b["mask"] = (rng.random((B, T)) < 0.4).astype(np.float32)
    return b


def _jax_loss_and_grads(jcfg, params, batch, remat=True):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    fn = jax.jit(jax.value_and_grad(
        lambda p: JM.train_loss(jcfg, p, jb, remat=remat)[0]))
    return fn(params)


def _port_loss_and_grads(model, batch, remat=True):
    model.requires_grad_(True)
    named = dict(model.named_parameters())
    loss, metrics = TM.train_loss(model, batch_to_device(batch, "cpu"),
                                  remat=remat)
    grads = torch.autograd.grad(loss, list(named.values()))
    return loss, metrics, dict(zip(named, grads))


def _setup(arch, seed=0):
    jcfg, tcfg = _configs(arch)
    params = JM.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, tcfg, params, model_params_from_numpy(tcfg, params,
                                                       device="cpu")


# every architecture's smoke config: the attention families (smollm, the
# dense deepseek / internlm2, gemma3 with its window of 32 binding at T 64,
# the MoE qwen3 / dbrx, qwen2-vl with embeddings and M-RoPE, the hubert
# encoder's masked-unit loss), and zamba2 / rwkv6, which train on the CPU
# through their kernels' plain versions
TRAIN_ARCHS = ["smollm-135m", "gemma3-4b", "hubert-xlarge", "deepseek-coder-33b",
               "internlm2-20b", "qwen3-moe-235b-a22b", "dbrx-132b",
               "qwen2-vl-72b", "zamba2-1.2b", "rwkv6-7b"]


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_loss_and_grads_match_jax(arch):
    """``train_loss`` (rtol 1e-5) and every gradient leaf (1e-4 of the
    leaf's largest magnitude) against JAX's on the same weights and
    batch; hubert's loss is over a random 40% of its frames.

    JAX's own gradients are not finite everywhere for the scan layers:
    zamba2's hold NaN in most leaves (``ssd_chunked`` takes exp of the
    positive cum[t] - cum[s] above the diagonal, which overflows, before
    masking it, and the masked gradient is 0 * inf), and the port, doing
    the same arithmetic, holds NaN in exactly the same elements; rwkv6's
    are NaN at T 64 (the 1e-30 floors of ``wkv_chunked``) and finite at T
    32, where the test holds it."""
    jcfg, tcfg, params, model = _setup(arch)
    batch = _batch(jcfg, masked=arch == "hubert-xlarge",
                   seq=32 if arch == "rwkv6-7b" else T)
    jloss, jgrads = _jax_loss_and_grads(jcfg, params, batch)
    loss, metrics, grads = _port_loss_and_grads(model, batch)
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=LOSS_RTOL)
    assert float(metrics["tokens"]) == float(batch["mask"].sum())
    _check_tree(params_to_numpy(tcfg, grads), jax.tree.map(np.asarray,
                                                            jgrads))


def test_remat_on_and_off_give_equal_grads():
    jcfg, tcfg, params, model = _setup("smollm-135m")
    batch = _batch(jcfg, seed=3)
    l1, _, g1 = _port_loss_and_grads(model, batch, remat=True)
    l0, _, g0 = _port_loss_and_grads(model, batch, remat=False)
    assert float(l1.detach()) == float(l0.detach())
    for n in g1:
        torch.testing.assert_close(g1[n], g0[n], rtol=0, atol=0)


def _jax_steps(jcfg, params, batches, **kw):
    step = jax.jit(jmake_train_step(jcfg, JAdamWConfig(lr=1e-3), **kw))
    opt = jinit_opt_state(params)
    if kw.get("compress"):
        opt["comp_err"] = jax.tree.map(lambda p: jnp.zeros(p.shape), params)
    metrics = []
    for b in batches:
        params, opt, m = step(params, opt, {k: jnp.asarray(v)
                                            for k, v in b.items()})
        metrics.append(m)
    return params, opt, metrics


SCHEDULE = {"warmup": 1, "total": 10}
# With compression an int8 value sits where fp / scale rounds; gradients
# that agree to float32 rounding move the few values within ~1e-6 of a .5
# tie by one step (1-7 of the 180,800 in these runs).  Such an element
# differs by at most one step's effect: an AdamW move of at most 2 lr in
# the weights, a tenth (m) or a twentieth (v, squared) of one quantum
# (2 / 127 of a block's largest gradient) in the moments, and one quantum
# in the carried error.  The rest hold the leaf tolerance; the carried
# error, a residual ~254 times smaller than the gradient it came from,
# holds 1e-4 of that gradient (2.5e-2 of its own largest value).
FLIP_FRACTION = 1e-4


def _check_flips(got: dict, want: dict, tol: float, flip_abs: float,
                 where: str):
    g = np.concatenate([np.asarray(x, np.float32).ravel()
                        for x in jax.tree.leaves(got)])
    w_leaves = jax.tree.leaves(want)
    w = np.concatenate([np.asarray(x, np.float32).ravel() for x in w_leaves])
    scale = np.concatenate([np.full(np.size(x), np.abs(x).max())
                            for x in w_leaves])
    off = np.abs(g - w) > tol * scale
    assert off.sum() <= FLIP_FRACTION * w.size, (where, int(off.sum()))
    assert (np.abs(g - w)[off] <= flip_abs).all(), (where, np.abs(g - w)[
        off].max())


@pytest.mark.parametrize("arch,accum,compress,remat", [
    pytest.param("smollm-135m", *case, id="-".join(map(str, case)))
    for case in ((1, False, True), (2, False, True), (1, True, False),
                 (2, True, True))] + [
    pytest.param(arch, 2, True, True, id=f"{arch}-2-True-True")
    for arch in ("qwen3-moe-235b-a22b", "qwen2-vl-72b")])
def test_train_steps_match_jax(arch, accum, compress, remat):
    """Two ``make_train_step`` steps (a warmup of one step, so the second
    moves the weights) against JAX's jitted step: loss, grad norm, lr
    scale and step exactly or to rtol 1e-5, and the new params, master,
    m and v leaf by leaf.  smollm takes every mode; the MoE (its stacked
    experts among the compressed leaves) and qwen2-vl (an embedding-input
    batch with M-RoPE positions) take accumulation, compression and remat
    together."""
    jcfg, tcfg, params, model = _setup(arch, seed=1)
    batches = [_batch(jcfg, seed=s) for s in (5, 6)]
    kw = dict(accum=accum, remat=remat, compress=compress,
              schedule_kwargs=SCHEDULE)
    jparams, jopt, jm = _jax_steps(jcfg, params, batches, **kw)
    model, opt = init_train_state(model, compress=compress)
    step = make_train_step(model, AdamWConfig(lr=1e-3), **kw)
    for b, want in zip(batches, jm):
        opt, m = step(opt, b)
        assert float(m["loss"]) == pytest.approx(float(want["loss"]),
                                                 rel=LOSS_RTOL)
        assert float(m["grad_norm"]) == pytest.approx(
            float(want["grad_norm"]), rel=1e-4)
        assert m["lr_scale"] == pytest.approx(float(want["lr_scale"]),
                                              rel=1e-6)
        assert m["step"] == int(want["step"])
    got = {"params": params_to_numpy(tcfg, model),
           **{k: params_to_numpy(tcfg, opt[k]) for k in ("master", "m", "v")}}
    want = {"params": jparams, **{k: jopt[k] for k in ("master", "m", "v")}}
    want = jax.tree.map(np.asarray, want)
    if not compress:
        _check_tree(got, want)
        return
    gmax = max(float(np.abs(x).max()) for x in jax.tree.leaves(want["m"]))
    gmax /= 1 - 0.9 ** 2      # the largest gradient, from m = 0.19 g
    quantum = 2 * gmax / 127
    for key, flip in (("params", 2e-3), ("master", 2e-3),
                      ("m", 0.1 * quantum), ("v", 0.05 * quantum * gmax)):
        _check_flips(got[key], want[key], LEAF_TOL, flip, key)
    err = jax.tree.map(np.asarray, jopt["comp_err"])
    _check_flips(params_to_numpy(tcfg, opt["comp_err"]), err, 2.5e-2,
                 2 * max(float(np.abs(x).max()) for x in jax.tree.leaves(err)),
                 "comp_err")


def test_optimizer_state_carried_from_jax_continues_as_jax():
    """JAX's state after one step, carried by ``opt_state_from_numpy``
    (with JAX's new weights), then one port step: equals JAX's second
    step."""
    jcfg, tcfg, params, _ = _setup("smollm-135m", seed=2)
    batches = [_batch(jcfg, seed=s) for s in (7, 8)]
    kw = dict(schedule_kwargs=SCHEDULE)
    p1, o1, _ = _jax_steps(jcfg, params, batches[:1], **kw)
    p2, o2, _ = _jax_steps(jcfg, params, batches, **kw)
    model = model_params_from_numpy(tcfg, p1, device="cpu")
    opt = opt_state_from_numpy(tcfg, o1, device="cpu")
    assert opt["step"] == 1
    step = make_train_step(model, AdamWConfig(lr=1e-3), **kw)
    opt, _ = step(opt, batches[1])
    _check_tree(params_to_numpy(tcfg, model), jax.tree.map(np.asarray, p2))
    _check_tree(params_to_numpy(tcfg, opt["v"]),
                jax.tree.map(np.asarray, o2["v"]))


def test_accumulation_matches_single_batch():
    """As ``tests/test_train.py::test_accumulation_matches_single_batch``:
    accum 2 and accum 1 on one batch give the same loss and nearly the
    same weights (every microbatch has the same token count)."""
    tcfg = tconfigs.get_smoke_config("smollm-135m")
    ds = SyntheticLM(tcfg.vocab_size, 64, 8, seed=0)
    b = ds.batch(100)
    out = []
    for accum in (1, 2):
        model, opt = init_train_state(
            TM.Model(tcfg, device="cpu"), torch.Generator().manual_seed(0))
        opt, m = make_train_step(model, AdamWConfig(lr=1e-3),
                                 accum=accum)(opt, b)
        out.append((float(m["loss"]), [p.detach().float().clone()
                                       for p in model.parameters()]))
    assert out[0][0] == pytest.approx(out[1][0], rel=1e-3)
    worst = max(float((a - c).abs().max())
                for a, c in zip(out[0][1], out[1][1]))
    assert worst < 5e-2, worst


def test_loss_decreases():
    """As ``tests/test_train.py::test_loss_decreases``: 20 steps of the
    smollm smoke model at lr 1e-3 bring the loss down by 0.1."""
    tcfg = tconfigs.get_smoke_config("smollm-135m")
    model, opt = init_train_state(TM.Model(tcfg, device="cpu"),
                                  torch.Generator().manual_seed(0))
    step = make_train_step(model, AdamWConfig(lr=1e-3))
    ds = SyntheticLM(tcfg.vocab_size, 64, 8, seed=0)
    losses = []
    for s in range(20):
        opt, m = step(opt, ds.batch(s))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.1, losses


def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 9, 33)).astype(np.float32) * 4
    labels = rng.integers(0, 33, (2, 9)).astype(np.int32)
    mask = (rng.random((2, 9)) < 0.5).astype(np.float32)
    want = JM.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                            jnp.asarray(mask))
    got = TM.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                           torch.from_numpy(mask))
    assert float(got) == pytest.approx(float(want), rel=1e-6)
    zero = TM.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                            torch.zeros((2, 9)))
    assert float(zero) == 0.0
