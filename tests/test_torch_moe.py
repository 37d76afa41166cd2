"""The port's MoE (``repro_torch.models.ffn``) against ``repro.models.ffn``
on the same numpy-made inputs: ``moe_ffn`` on the block and the naive
dispatch paths, the routing behind it (experts, positions in each
expert's rows and keep masks exactly, in float32), the top-k tie order,
``moe_aux_loss``, and a smoke MoE model with ``moe_impl="naive"``.

Tolerances: float32 1e-5 (the same products summed in another order);
bfloat16 the model tests' 5e-2 / 1e-1.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.models import ffn as jffn
from repro.models import model as M
from repro_torch import configs as tconfigs
from repro_torch.convert import model_params_from_numpy
from repro_torch.models import ffn as tffn

TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=5e-2, atol=1e-1)}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# (E, k, D, F) of the qwen3-moe and dbrx smoke configs
SHAPES = {"qwen3": (8, 2, 64, 64), "dbrx": (4, 2, 64, 96)}


def _inputs(name, B, T, seed, dtype="float32"):
    E, k, D, F = SHAPES[name]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    router = (rng.standard_normal((D, E)) / np.sqrt(D)).astype(np.float32)
    w = [(rng.standard_normal(s) / np.sqrt(s[1])).astype(np.float32)
         for s in ((E, D, F), (E, D, F), (E, F, D))]
    jx = [jnp.asarray(x).astype(JNP[dtype]), jnp.asarray(router),
          *[jnp.asarray(a).astype(JNP[dtype]) for a in w]]
    tx = [torch.from_numpy(x).to(TORCH[dtype]), torch.from_numpy(router),
          *[torch.from_numpy(a).to(TORCH[dtype]) for a in w]]
    return k, jx, tx


def _f32(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else
                      jnp.asarray(a, jnp.float32))


def _jax_route(x, router, k, capacity_factor, block_dispatch):
    """The first half of JAX's ``moe_ffn``, line for line, returning what
    it computes on the way (JAX's function keeps it inside)."""
    B, T, D = x.shape
    E = router.shape[1]
    N = B * T
    NB = jffn._num_blocks(N) if block_dispatch else 1
    Nb = N // NB
    cap = max(1, int(capacity_factor * Nb * k / E))
    logits = jnp.einsum("bnd,de->bne", x.reshape(NB, Nb, D).astype(
        jnp.float32), router.astype(jnp.float32))
    gate, idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), k)
    gate = gate / jnp.maximum(gate.sum(-1, keepdims=True), 1e-9)
    oh = jax.nn.one_hot(idx, E, dtype=jnp.int32).reshape(NB, Nb * k, E)
    pos = ((jnp.cumsum(oh, axis=1) - oh) * oh).sum(-1).reshape(NB, Nb, k)
    keep = pos < cap
    return dict(NB=NB, Nb=Nb, cap=cap, logits=logits, expert_idx=idx,
                pos=pos, keep=keep, gate=jnp.where(keep, gate, 0.0))


@pytest.mark.parametrize("block", [True, False])
@pytest.mark.parametrize("B,T,cf", [(2, 128, 1.25), (1, 40, 1.0),
                                    (3, 7, 2.0)])
@pytest.mark.parametrize("name", list(SHAPES))
def test_routing_matches_jax_exactly(name, B, T, cf, block):
    """Experts, positions, keep masks and capacities equal JAX's; gates
    and logits to float32 rounding.  At the smoke's B 2, T 128 the block
    path's capacity is 2 (qwen3) and tokens are dropped."""
    k, (jx, jr, *_), (x, r, *_) = _inputs(name, B, T, B * T)
    want = _jax_route(jx, jr, k, cf, block)
    got = tffn.moe_route(x, r, experts_per_tok=k, capacity_factor=cf,
                         block_dispatch=block)
    for key in ("NB", "Nb", "cap"):
        assert got[key] == want[key], key
    for key in ("expert_idx", "pos", "keep"):
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]), err_msg=key)
    for key in ("logits", "gate"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   **TOL["float32"], err_msg=key)
    if (name, B, T, cf, block) == ("qwen3", 2, 128, 1.25, True):
        assert got["cap"] == 2 and not got["keep"].all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("block", [True, False])
@pytest.mark.parametrize("name", list(SHAPES))
def test_moe_ffn_matches_jax(name, block, dtype):
    k, jargs, targs = _inputs(name, 2, 128, 11, dtype)
    want = jffn.moe_ffn(*jargs, experts_per_tok=k, capacity_factor=1.25,
                        block_dispatch=block)
    got = tffn.moe_ffn(*targs, experts_per_tok=k, capacity_factor=1.25,
                       block_dispatch=block)
    assert got.dtype == targs[0].dtype and got.shape == targs[0].shape
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL[dtype])


def test_dropped_tokens_add_nothing():
    """A token whose every slot overflows its expert's capacity leaves the
    MoE with zeros, in both packages."""
    k, jargs, targs = _inputs("dbrx", 1, 64, 3)
    got = tffn.moe_ffn(*targs, experts_per_tok=k, capacity_factor=0.1)
    want = jffn.moe_ffn(*jargs, experts_per_tok=k, capacity_factor=0.1)
    r = tffn.moe_route(targs[0], targs[1], experts_per_tok=k,
                       capacity_factor=0.1)
    dropped = ~r["keep"].any(-1).reshape(-1)
    assert dropped.any()
    assert float(got.reshape(-1, got.shape[-1])[dropped].abs().max()) == 0
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL["float32"])


def test_top_k_breaks_ties_as_jax():
    probs = np.array([[0.2, 0.3, 0.2, 0.3], [0.25, 0.25, 0.25, 0.25],
                      [0.1, 0.4, 0.4, 0.1]], np.float32)
    for k in (1, 2, 3):
        jv, ji = jax.lax.top_k(jnp.asarray(probs), k)
        tv, ti = tffn.top_k(torch.from_numpy(probs), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_moe_aux_loss_matches_jax():
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((50, 8)).astype(np.float32)
    idx = rng.integers(0, 8, (50, 2)).astype(np.int32)
    want = jffn.moe_aux_loss(jnp.asarray(logits), jnp.asarray(idx), 8)
    got = tffn.moe_aux_loss(torch.from_numpy(logits),
                            torch.from_numpy(idx).long(), 8)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "dbrx-132b"])
def test_naive_dispatch_model_matches_jax(arch):
    """``moe_impl="naive"`` (one block) through the whole smoke model:
    prefill logits against JAX's on JAX's weights, float32."""
    jcfg = dataclasses.replace(jget_smoke(arch), dtype=jnp.float32,
                               moe_impl="naive")
    tcfg = dataclasses.replace(tconfigs.get_smoke_config(arch),
                               dtype=torch.float32, moe_impl="naive")
    params = M.init_params(jcfg, jax.random.PRNGKey(2))
    model = model_params_from_numpy(tcfg, params, device="cpu")
    toks = np.random.default_rng(2).integers(0, 256, (2, 64)).astype(
        np.int32)
    want, _ = jax.jit(lambda p, b: M.prefill(jcfg, p, b))(
        params, {"tokens": jnp.asarray(toks)})
    got, _ = model.prefill(torch.from_numpy(toks).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_moe_layer_keeps_jax_names_and_layouts():
    cfg = tconfigs.get_config("qwen3-moe-235b-a22b")
    from repro_torch.models.model import Model

    layer = Model(cfg, device="meta").layers[0]
    shapes = {n: tuple(p.shape) for n, p in layer.named_parameters()}
    E, D, F = cfg.num_experts, cfg.d_model, cfg.d_ff
    assert shapes["router"] == (D, E) and layer.router.dtype == torch.float32
    assert shapes["w_gate"] == shapes["w_up"] == (E, D, F)
    assert shapes["w_down"] == (E, F, D)
    jshapes = jax.eval_shape(lambda: M.init_params(
        jget_smoke("qwen3-moe-235b-a22b"), jax.random.PRNGKey(0)))
    assert set(jshapes["groups"][0]) == set(
        n for n, _ in Model(tconfigs.get_smoke_config("qwen3-moe-235b-a22b"),
                            device="meta").layers[0].named_parameters())


def test_port_init_draws_moe_fan_ins():
    """The port's own init: router and ``w_gate`` with fan-in D, ``w_down``
    (E, F, D) with fan-in F (JAX's ``in_axis=-2``), truncated at 3 sigma."""
    from repro_torch.models.model import Model

    cfg = dataclasses.replace(tconfigs.get_smoke_config("dbrx-132b"),
                              d_model=256, d_ff=384, num_experts=64,
                              dtype=torch.float32)
    layer = Model(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(0)).layers[0]
    for w, fan in ((layer.router, 256), (layer.w_gate, 256),
                   (layer.w_down, 384)):
        std = 1 / np.sqrt(fan)
        assert abs(float(w.std()) / std - 0.9866) < 0.03
        assert float(w.abs().max()) <= 3 * std + 1e-6
    assert layer.router.dtype == torch.float32
