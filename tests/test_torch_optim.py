"""The port's optimizer pieces (``repro_torch.optim``) and the optimizer
state's carry against ``repro.optim`` on the same numpy-made inputs:
int8 compression bit for bit, the LR schedule at every step of a grid,
AdamW's update (clipping, bias corrections, decoupled decay on the
float32 master), and the mirrored ``tests/test_train.py`` behaviours."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.models import model as JM
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_update as jadamw_update
from repro.optim import init_opt_state as jinit_opt_state
from repro.optim import lr_schedule as jlr_schedule
from repro.optim.compress import compress_leaf as jcompress_leaf
from repro_torch import configs as tconfigs
from repro_torch.convert import (
    model_params_from_numpy,
    opt_state_from_numpy,
    opt_state_to_numpy,
    params_to_numpy,
)
from repro_torch.models.model import Model
from repro_torch.optim import (
    AdamWConfig,
    adamw_update,
    compress_grads,
    decompress_grads,
    init_opt_state,
    lr_schedule,
)
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import compress as tcompress
from repro_torch.optim.compress import (
    compress_leaf,
    compress_roundtrip_,
    decompress_leaf,
)
from repro_torch.train.train_step import jax_leaf_groups


def _bits(t):
    return np.asarray(t).view(np.uint8) if np.asarray(t).dtype == np.int8 \
        else np.asarray(t, np.float32).view(np.uint32)


@pytest.mark.parametrize("n", [1000, 256, 77, 4096 + 5])
@pytest.mark.parametrize("with_err", [False, True])
def test_compress_leaf_equals_jax_bit_for_bit(n, with_err):
    """Quantized values, scales and carried errors equal JAX's bits on the
    same float32 gradient (and carried error), ragged lengths padded to
    whole blocks of 256; a zero block keeps the 1e-12 scale floor."""
    rng = np.random.default_rng(n)
    g = (rng.standard_normal((n,)) * 0.1).astype(np.float32)
    g[: min(n, 256)] *= 0 if n == 256 else 1
    err = ((rng.standard_normal((n,)) * 1e-3).astype(np.float32)
           if with_err else None)
    (jq, js), jerr = jcompress_leaf(jnp.asarray(g),
                                    None if err is None else jnp.asarray(err))
    (q, s), terr = compress_leaf(torch.from_numpy(g),
                                 None if err is None else torch.from_numpy(err))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(_bits(s.numpy()), _bits(js))
    np.testing.assert_array_equal(_bits(terr.numpy()), _bits(jerr))


def test_compression_roundtrip_error_bounded():
    """As ``tests/test_train.py``: dequantized within 2% of the largest
    value, and dequantized + carried error = the gradient."""
    g = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1000,)).astype(np.float32) * 0.1)
    (q, s), err = compress_leaf(g)
    deq = decompress_leaf(q, s, g.shape)
    assert float((deq - g).abs().max() / g.abs().max()) < 0.02
    np.testing.assert_allclose((deq + err).numpy(), g.numpy(), rtol=1e-5,
                               atol=1e-7)


def test_compression_error_feedback_converges_as_jax():
    """Twenty steps of error feedback: the running sum of dequantized
    gradients tracks the true sum within one quantization step, and every
    step's int8 values and carried error equal JAX's bits."""
    rng = np.random.default_rng(1)
    err, jerr = torch.zeros(256), jnp.zeros((256,))
    total_true, total_deq = torch.zeros(256), torch.zeros(256)
    for _ in range(20):
        g = (rng.standard_normal((256,)) * 0.01).astype(np.float32)
        (q, s), err = compress_leaf(torch.from_numpy(g), err)
        (jq, _), jerr = jcompress_leaf(jnp.asarray(g), jerr)
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(_bits(err.numpy()), _bits(jerr))
        total_true += torch.from_numpy(g)
        total_deq += decompress_leaf(q, s, (256,))
    assert float((total_true - total_deq).abs().max()) < 1e-3


def test_compress_grads_tree_and_groups():
    """As ``tests/test_train.py::test_compress_grads_tree``, and grouped
    leaves: a group compresses as its members joined (JAX's stacked
    leaf), its carried errors split back by member."""
    tree = {"a": torch.ones((10, 10)), "b": torch.full((5,), -2.0)}
    cg, err = compress_grads(tree)
    out = decompress_grads(cg, tree)
    torch.testing.assert_close(out["a"], torch.ones((10, 10)), rtol=1e-2,
                               atol=0)
    torch.testing.assert_close(out["b"], torch.full((5,), -2.0), rtol=1e-2,
                               atol=0)
    rng = np.random.default_rng(2)
    parts = [rng.standard_normal((3, 64)).astype(np.float32) for _ in
             range(4)]
    grads = {f"l{i}": torch.from_numpy(p) for i, p in enumerate(parts)}
    cg, err = compress_grads(grads, groups=[list(grads)])
    (jq, js), jerr = jcompress_leaf(jnp.asarray(np.stack(parts)))
    (names, (q, s)), = cg
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(_bits(s.numpy()), _bits(js))
    np.testing.assert_array_equal(
        np.stack([err[n].numpy() for n in names]), np.asarray(jerr))


@pytest.mark.parametrize("kind", ["cosine", "constant", "rsqrt"])
def test_lr_schedule_equals_jax_on_a_grid(kind):
    for warmup, total in ((200, 10_000), (10, 20), (1, 10), (0, 5)):
        for step in list(range(0, 30)) + [199, 200, 201, 5000, 9999, 10_000,
                                          12_000]:
            want = float(jlr_schedule(step, warmup=warmup, total=total,
                                      kind=kind))
            got = lr_schedule(step, warmup=warmup, total=total, kind=kind)
            # (rsqrt at warmup 0, step 0 is 0 / 0 in both: NaN)
            assert got == pytest.approx(want, rel=1e-6, abs=1e-7,
                                        nan_ok=True), (kind, warmup, total,
                                                       step)


def test_lr_schedule_shapes():
    assert lr_schedule(0, warmup=100, total=1000) == 0.0
    assert lr_schedule(100, warmup=100, total=1000) == pytest.approx(1.0)
    assert lr_schedule(1000, warmup=100, total=1000) == pytest.approx(
        0.1, rel=1e-3)
    assert lr_schedule(50, warmup=100, kind="constant") == 0.5


def test_grad_clip_limits_update():
    """As ``tests/test_train.py``: the reported norm is before clipping,
    and the clipped update equals JAX's."""
    params = {"w": torch.ones(4)}
    opt = init_opt_state(params)
    new, opt, gnorm = adamw_update(params, {"w": torch.full((4,), 1e6)}, opt,
                                   AdamWConfig(grad_clip=1.0))
    assert float(gnorm) > 1e5
    jnew, _, _ = jadamw_update({"w": jnp.ones((4,))},
                               {"w": jnp.full((4,), 1e6)},
                               jinit_opt_state({"w": jnp.ones((4,))}),
                               JAdamWConfig(grad_clip=1.0))
    np.testing.assert_allclose(new["w"].numpy(), np.asarray(jnp.asarray(
        jnew["w"], jnp.float32)), rtol=1e-6)


@pytest.mark.parametrize("with_err", [True, False])
@pytest.mark.parametrize("chunk", [256, 768, 1 << 20])
def test_compress_roundtrip_equals_compress_then_decompress(
        monkeypatch, chunk, with_err):
    """The train step's round trip (a group whole, or in place by chunks)
    against ``compress_grads`` then ``decompress_grads`` bit for bit:
    chunks of one block, of three (which cut leaves and straddle a group's
    members) and of the whole tree; groups of several members, one member,
    and a ragged last block."""
    rng = np.random.default_rng(5)
    shapes = {"a": (3, 100), "b": (7,), "c": (2, 300), "d": (1000,),
              "e": (33, 17)}
    grads = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
             for k, s in shapes.items()}
    err = ({k: torch.from_numpy((rng.standard_normal(s) * 1e-2).astype(
        np.float32)) for k, s in shapes.items()} if with_err else None)
    groups = [["a", "b", "c"], ["d"], ["e"]]
    cg, want_err = compress_grads(grads, err, groups)
    want = decompress_grads(cg, grads)
    got = {k: v.clone() for k, v in grads.items()}
    monkeypatch.setattr(tcompress, "CHUNK", chunk)
    got_err = compress_roundtrip_(
        got, None if err is None else {k: v.clone() for k, v in err.items()},
        groups)
    for k in shapes:
        np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]))
        np.testing.assert_array_equal(_bits(got_err[k]), _bits(want_err[k]))


@pytest.mark.parametrize("chunk", [1, 64, 300])
def test_adamw_passes_give_the_bits_of_one_pass(monkeypatch, chunk):
    """AdamW's passes over cut and joined leaves (``CHUNK`` values each)
    against one pass over every leaf, bit for bit, clipped; the gradients
    are left as they were."""
    rng = np.random.default_rng(6)
    shapes = {"a": (7, 5), "b": (300,), "c": (2, 3, 4), "d": (1,)}
    params = {k: torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).to(torch.bfloat16) for k, s in shapes.items()}
    g = {k: torch.from_numpy((rng.standard_normal(s) * 3).astype(
        np.float32)) for k, s in shapes.items()}
    kept = {k: v.clone() for k, v in g.items()}
    out = {}
    for name, n in (("one", 1 << 30), ("passes", chunk)):
        monkeypatch.setattr(tadamw, "CHUNK", n)
        opt = init_opt_state(params)
        for _ in range(2):
            new, opt, gnorm = adamw_update(params, g, opt,
                                           AdamWConfig(lr=1e-2), 0.7)
        out[name] = (new, opt, gnorm)
    for k in shapes:
        assert torch.equal(out["one"][0][k], out["passes"][0][k])
        for key in ("master", "m", "v"):
            assert torch.equal(out["one"][1][key][k],
                               out["passes"][1][key][k])
        assert torch.equal(g[k], kept[k])
    assert float(out["one"][2]) > 1.0     # the clip binds
    assert torch.equal(out["one"][2], out["passes"][2])


@pytest.mark.parametrize("clip", [1.0, 100.0])
def test_adamw_steps_equal_jax(clip):
    """Five AdamW steps on float32 master weights and bf16 compute
    params with weight decay, the global norm clipped (or not), against
    JAX's update: params (bf16 of the master), master, m, v, step and the
    grad norm."""
    rng = np.random.default_rng(3)
    shapes = {"a": (7, 5), "b": (300,), "c": (2, 3, 4)}
    p0 = {k: rng.standard_normal(s).astype(np.float32) for k, s in
          shapes.items()}
    cfg = dict(lr=1e-2, weight_decay=0.1, grad_clip=clip)
    params = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in
              p0.items()}
    jparams = {k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in
               p0.items()}
    opt = init_opt_state(params)
    jopt = jinit_opt_state(jparams)
    for step in range(5):
        g = {k: (rng.standard_normal(s) * 3).astype(np.float32) for k, s in
             shapes.items()}
        scale = 0.5 + 0.1 * step
        params, opt, gnorm = adamw_update(
            params, {k: torch.from_numpy(v) for k, v in g.items()}, opt,
            AdamWConfig(**cfg), scale)
        jparams, jopt, jgnorm = jadamw_update(
            jparams, {k: jnp.asarray(v) for k, v in g.items()}, jopt,
            JAdamWConfig(**cfg), jnp.float32(scale))
        assert float(gnorm) == pytest.approx(float(jgnorm), rel=1e-6)
        assert opt["step"] == int(jopt["step"])
        for k in shapes:
            assert params[k].dtype == torch.bfloat16
            for key in ("master", "m", "v"):
                np.testing.assert_allclose(opt[key][k].numpy(),
                                           np.asarray(jopt[key][k]),
                                           rtol=2e-6, atol=1e-7)
            np.testing.assert_allclose(
                params[k].float().numpy(),
                np.asarray(jnp.asarray(jparams[k], jnp.float32)),
                rtol=1e-2, atol=0)


def _smoke(arch="smollm-135m"):
    jcfg = dataclasses.replace(jget_smoke(arch), dtype=jnp.float32)
    tcfg = dataclasses.replace(tconfigs.get_smoke_config(arch),
                               dtype=torch.float32)
    return jcfg, tcfg


@pytest.mark.parametrize("arch", ["smollm-135m", "gemma3-4b", "zamba2-1.2b",
                                  "qwen2-vl-72b"])
def test_params_round_trip_through_jax_layout(arch):
    """``params_to_numpy(model_params_from_numpy(tree))`` gives JAX's tree
    back exactly: the groups stacked over repeats, the tail, the shared
    block, the embedding where there is one."""
    jcfg, tcfg = _smoke(arch)
    tree = JM.init_params(jcfg, jax.random.PRNGKey(4))
    back = params_to_numpy(tcfg, model_params_from_numpy(tcfg, tree,
                                                         device="cpu"))
    flat_w, tdef = jax.tree.flatten(jax.tree.map(np.asarray, tree))
    flat_g, gdef = jax.tree.flatten(back)
    assert tdef == gdef
    for a, b in zip(flat_g, flat_w):
        np.testing.assert_array_equal(a, b)


def test_opt_state_round_trip_through_jax_layout():
    """JAX's AdamW state (with the compressor's carried error) -> the
    port's -> JAX's layout, exactly; keyed by the model's names in its
    order, ``step`` an int."""
    jcfg, tcfg = _smoke()
    params = JM.init_params(jcfg, jax.random.PRNGKey(5))
    rng = np.random.default_rng(5)
    noise = lambda p: jnp.asarray(  # noqa: E731
        rng.standard_normal(p.shape).astype(np.float32))
    jopt = jinit_opt_state(params)
    jopt["m"] = jax.tree.map(noise, params)
    jopt["v"] = jax.tree.map(lambda p: noise(p) ** 2, params)
    jopt["comp_err"] = jax.tree.map(noise, params)
    jopt["step"] = jnp.int32(7)
    opt = opt_state_from_numpy(tcfg, jopt, device="cpu")
    names = [n for n, _ in Model(tcfg, device="meta").named_parameters()]
    assert list(opt["master"]) == names and opt["step"] == 7
    back = opt_state_to_numpy(tcfg, opt)
    assert int(back["step"]) == 7
    for key in ("master", "m", "v", "comp_err"):
        for a, b in zip(jax.tree.leaves(back[key]),
                        jax.tree.leaves(jax.tree.map(np.asarray,
                                                     jopt[key]))):
            np.testing.assert_array_equal(a, b)


def test_jax_leaf_groups_follow_the_stacked_tree():
    """Every parameter in one group, each group one of JAX's leaves: the
    pattern positions' layers in repeat order, the tail and top-level
    parameters alone."""
    for arch in ("gemma3-4b", "zamba2-1.2b"):
        _, tcfg = _smoke(arch)
        model = Model(tcfg, device="meta")
        groups = jax_leaf_groups(model)
        names = [n for n, _ in model.named_parameters()]
        assert sorted(sum(groups, [])) == sorted(names)
        tree = params_to_numpy(tcfg, {n: torch.zeros(p.shape) for n, p in
                                      model.named_parameters()})
        assert len(groups) == len(jax.tree.leaves(tree))
        n = len(tcfg.pattern)
        for g in groups:
            if len(g) > 1:
                idx = [int(x.split(".")[1]) for x in g]
                assert idx == list(range(idx[0], n * tcfg.repeats, n))
