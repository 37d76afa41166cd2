"""The port's models (``repro_torch.models``) against ``repro.models`` on
the same weights: ``model_params_from_numpy`` carries JAX's
``init_params`` tree into the port, then prefill logits, every cache leaf
and the decode step's logits are compared on the smoke configs of every
ported architecture (zamba2, smollm, rwkv6, the dense deepseek-coder and
internlm2, gemma3 with its window of 32 binding at T 128, the MoE qwen3
and dbrx, qwen2-vl with embedding inputs and M-RoPE positions whose three
streams differ, the non-causal hubert encoder), in float32 (the
algorithm; tight) and bfloat16 (the working type; loose), plus the port's
own prefill-then-decode against its full forward.  hubert is left out of
the decode tests, as ``tests/test_archs_smoke.py`` leaves it out: an
encoder has no decode path."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke
from repro.models import model as M
from repro_torch import configs as tconfigs
from repro_torch.convert import model_params_from_numpy
from repro_torch.models import model as TM


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the module's tests: under the suite's
    several worker processes, torch's default of one thread a core in each
    makes their small CPU kernels spin against each other, and alone on an
    8-core CPU the module took 102 s at one thread against 167 s at eight."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ARCHS = ["zamba2-1.2b", "smollm-135m", "rwkv6-7b", "deepseek-coder-33b",
         "internlm2-20b", "gemma3-4b", "qwen3-moe-235b-a22b", "dbrx-132b",
         "qwen2-vl-72b", "hubert-xlarge"]
DECODE_ARCHS = [a for a in ARCHS if a != "hubert-xlarge"]
# float32: the same arithmetic in another order (XLA's fused scans against
# torch's ops), a few ulps per layer.  bfloat16: the port rounds to bf16
# wherever JAX's code casts, but XLA on the CPU keeps elementwise chains
# inside a fusion in float32 (xla_allow_excess_precision, on by default),
# so single values drift by up to ~12 bf16 ulps of the O(1) activations
# (0.1); the mean error stays at about two ulps (BF16_MEAN).  The prefill
# and decode comparisons compile JAX with that option off (``_jax_run``):
# then the smoke logits agree to 1-5 ulps (rwkv6 0.008, zamba2 0.016,
# smollm 0.035), where with it on rwkv6's drift past these limits (0.19,
# mean 0.030) although every shift leaf matches exactly with it off.
TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=5e-2, atol=1e-1)}
BF16_MEAN = 2e-2
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
B, T = 2, 128


def _configs(arch, dtype):
    jd, td = DTYPES[dtype]
    return (dataclasses.replace(jget_smoke(arch), dtype=jd),
            dataclasses.replace(tconfigs.get_smoke_config(arch), dtype=td))


def _tokens(cfg, seed, n=T):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, n)).astype(np.int32)


def grid_positions(n, grid, lead=(0, 5)):
    """(3, B, n) M-RoPE positions of Qwen2-VL's kind: row b has ``lead[b]``
    text tokens, a ``grid`` x ``grid`` image (t = lead, h = lead + row,
    w = lead + col), then text again from the image's largest position
    plus one, the same value in all three streams."""
    pos = np.zeros((3, B, n), np.int32)
    for b, t0 in enumerate(lead):
        pos[:, b, :t0] = np.arange(t0)
        r, c = np.divmod(np.arange(grid * grid), grid)
        img = slice(t0, t0 + grid * grid)
        pos[0, b, img] = t0
        pos[1, b, img] = t0 + r
        pos[2, b, img] = t0 + c
        rest = n - (t0 + grid * grid)
        pos[:, b, t0 + grid * grid:] = t0 + grid + np.arange(rest)
    return pos


def _batch(cfg, seed, n=T, grid=True):
    """JAX's batch and the port's keyword arguments on the same inputs:
    tokens, or float32 embeddings (B, n, D), with image-grid M-RoPE
    positions (``grid``) where the config has sections."""
    if not cfg.embed_inputs:
        toks = _tokens(cfg, seed, n)
        return {"tokens": jnp.asarray(toks)}, {
            "tokens": torch.from_numpy(toks).long()}
    e = np.random.default_rng(seed).standard_normal(
        (B, n, cfg.d_model)).astype(np.float32)
    jb, tb = {"embeds": jnp.asarray(e)}, {"embeds": torch.from_numpy(e)}
    if cfg.mrope_sections and grid:
        pos = grid_positions(n, 8)
        jb["positions"] = jnp.asarray(pos)
        tb["positions"] = torch.from_numpy(pos)
    return jb, tb


def _last(jb, tb):
    """The batches cut to all but the last position, and the last one as
    JAX's and the port's decode inputs."""
    key = "embeds" if "embeds" in jb else "tokens"
    pre_j = {key: jb[key][:, :-1]}
    pre_t = {key: tb[key][:, :-1]}
    if "positions" in jb:
        pre_j["positions"] = jb["positions"][..., :-1]
        pre_t["positions"] = tb["positions"][..., :-1]
    dec_j = {"embeds" if key == "embeds" else "token": jb[key][:, -1:]}
    dec_t = {"embeds": tb[key][:, -1:]} if key == "embeds" else {
        "token": tb[key][:, -1:]}
    return pre_j, pre_t, dec_j, dec_t


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _jax_layer_caches(cfg, cache):
    """JAX's prefill cache (groups stacked over repeats, then the tail) as
    one per-layer list in execution order."""
    n = len(cfg.pattern)
    out = [None] * cfg.num_layers
    for i, group in enumerate(cache["groups"]):
        for r in range(cfg.repeats):
            out[r * n + i] = jax.tree.map(lambda a: a[r], group)
    for j, tail in enumerate(cache["tail"]):
        out[cfg.repeats * n + j] = tail
    return out


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def _close(got, want, dtype, what=""):
    got, want = _np(got), _np(want)
    np.testing.assert_allclose(got, want, **TOL[dtype], err_msg=what)
    if dtype == "bfloat16":
        assert np.abs(got - want).mean() < BF16_MEAN, what


def _jax_run(fn, *args):
    """``fn(*args)`` jitted, compiled without XLA's excess precision."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def _build(arch, dtype):
    jcfg, tcfg = _configs(arch, dtype)
    params = M.init_params(jcfg, jax.random.PRNGKey(7))
    return jcfg, tcfg, params, model_params_from_numpy(tcfg, params,
                                                       device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_every_cache_leaf_match_jax(arch, dtype):
    jcfg, tcfg, params, model = _build(arch, dtype)
    jb, tb = _batch(jcfg, 1)
    jlogits, jcache = _jax_run(lambda p, b: M.prefill(jcfg, p, b), params, jb)
    logits, cache = model.prefill(**tb)
    _close(logits, jlogits, dtype, "logits")
    assert cache.len == int(jcache["len"]) == T
    jl = _jax_layer_caches(jcfg, jcache)
    assert len(jl) == len(cache.layers) == jcfg.num_layers
    for i, (jc, tc) in enumerate(zip(jl, cache.layers)):
        jleaves = {p: v for p, v in _leaves(jc) if not p.endswith("/len")}
        tleaves = dict(_leaves(tc))
        assert set(jleaves) == set(tleaves), (i, sorted(jleaves))
        for path, jv in jleaves.items():
            tv = tleaves[path]
            assert tuple(tv.shape) == tuple(jv.shape), (i, path)
            if path.endswith(("ssm", "state")):
                assert tv.dtype == torch.float32
            _close(tv, jv, dtype, f"layer {i} {path}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_decode_step_logits_match_jax(arch, dtype):
    jcfg, tcfg, params, model = _build(arch, dtype)
    pre_j, pre_t, dec_j, dec_t = _last(*_batch(jcfg, 2, T + 1))
    _, jcache = _jax_run(lambda p, b: M.prefill(jcfg, p, b), params, pre_j)
    full = M.init_cache(jcfg, B, T + 4)

    def place(dst, src):  # JAX's cache grown to T + 4 positions
        if hasattr(dst, "ndim") and dst.ndim >= 2 and dst.shape != src.shape:
            return dst.at[tuple(slice(0, d) for d in src.shape)].set(
                src.astype(dst.dtype))
        return src

    jcache = jax.tree.map(place, full, jcache)
    jlogits, _ = _jax_run(lambda p, c, b: M.decode_step(jcfg, p, c, b),
                          params, jcache, dec_j)
    _, cache = model.prefill(max_seq=T + 4, **pre_t)
    logits, cache = model.decode_step(cache=cache, **dec_t)
    assert cache.len == T + 1
    _close(logits, jlogits, dtype, "decode logits")


def test_zamba2_conv_cache_owns_its_storage_and_greedy_tokens_match_jax():
    """After a prefill every Mamba layer's conv cache is a (B, K-1, C)
    tensor with storage of its own (not a view of the layer's padded
    input); greedy decoding from that cache picks JAX's tokens (float32)."""
    jcfg, tcfg, params, model = _build("zamba2-1.2b", "float32")
    toks = _tokens(jcfg, 4)
    steps = 3
    logits, cache = model.prefill(torch.from_numpy(toks).long(),
                                  max_seq=T + steps)
    convs = [layer["conv"] for layer in cache.layers if "conv" in layer]
    assert convs
    for c in convs:
        assert c.shape[:2] == (B, tcfg.ssm_conv - 1) and c._base is None
        assert c.untyped_storage().nbytes() == c.numel() * c.element_size()
    _, jcache = _jax_run(lambda p, b: M.prefill(jcfg, p, b), params,
                         {"tokens": jnp.asarray(toks)})
    full = M.init_cache(jcfg, B, T + steps)
    jcache = jax.tree.map(
        lambda d, s: d.at[tuple(slice(0, n) for n in s.shape)].set(
            s.astype(d.dtype)) if hasattr(d, "ndim") and d.ndim >= 2
        and d.shape != s.shape else s, full, jcache)
    jstep = jax.jit(lambda p, c, b: M.decode_step(jcfg, p, c, b))
    tok = logits.argmax(-1, keepdim=True)
    jtok = jnp.asarray(tok.numpy().astype(np.int32))
    for _ in range(steps):
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
        logits, cache = model.decode_step(tok, cache)
        jlogits, jcache = jstep(params, jcache, {"token": jtok})
        tok = logits.argmax(-1, keepdim=True)
        jtok = jnp.argmax(jlogits, -1, keepdims=True).astype(jnp.int32)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))


def test_gqa_nine_over_three_matches_jax():
    """smollm-135m's head layout (9 query heads over 3 KV heads) at smoke
    width: prefill logits against JAX in float32."""
    jcfg, tcfg = _configs("smollm-135m", "float32")
    jcfg = dataclasses.replace(jcfg, num_heads=9, num_kv_heads=3)
    tcfg = dataclasses.replace(tcfg, num_heads=9, num_kv_heads=3)
    params = M.init_params(jcfg, jax.random.PRNGKey(5))
    model = model_params_from_numpy(tcfg, params, device="cpu")
    toks = _tokens(jcfg, 5, 64)
    jlogits, _ = jax.jit(lambda p, b: M.prefill(jcfg, p, b))(
        params, {"tokens": jnp.asarray(toks)})
    logits, _ = model.prefill(torch.from_numpy(toks).long())
    _close(logits, jlogits, "float32", "9/3 prefill logits")


@pytest.mark.parametrize("T_", [64, 100])
@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_prefill_then_decode_matches_forward(arch, T_):
    """decode(prefill(x[:-1]), x[-1]) equals forward(x) at the last
    position (float32; a ragged length too, which JAX cannot prefill);
    qwen2-vl at its default positions, equal streams, as JAX's own test
    takes them: only then is JAX's decode position the forward's."""
    _, tcfg = _configs(arch, "float32")
    if tcfg.num_experts:
        # capacity drops depend on the tokens in a call; full capacity makes
        # the routing per token, as tests/test_archs_smoke.py does for JAX
        tcfg = dataclasses.replace(
            tcfg, capacity_factor=tcfg.num_experts / tcfg.experts_per_tok)
    model = TM.Model(tcfg, device="cpu").init_params(
        torch.Generator().manual_seed(3))
    jb, tb = _batch(tcfg, 3, T_, grid=False)
    full = model(**tb)
    _, pre, _, dec = _last(jb, tb)
    last, cache = model.prefill(max_seq=T_, **pre)
    np.testing.assert_allclose(last.numpy(), full[:, -2].numpy(), rtol=1e-5,
                               atol=1e-5)
    logits, _ = model.decode_step(cache=cache, **dec)
    np.testing.assert_allclose(logits.numpy(), full[:, -1].numpy(),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_num_params_matches_jax(arch):
    assert TM.num_params(tconfigs.get_config(arch)) == \
        M.num_params(jget_config(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_active_params_matches_jax(arch):
    assert TM.active_params(tconfigs.get_config(arch)) == \
        M.active_params(jget_config(arch))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("smoke", [False, True])
def test_config_fields_match_jax(arch, smoke):
    t = (tconfigs.get_smoke_config if smoke else tconfigs.get_config)(arch)
    j = (jget_smoke if smoke else jget_config)(arch)
    for f in dataclasses.fields(t):
        if f.name in ("dtype", "use_kernels"):
            continue
        tv, jv = getattr(t, f.name), getattr(j, f.name)
        if f.name in ("pattern", "tail"):
            tv = [dataclasses.astuple(s) for s in tv]
            jv = [dataclasses.astuple(s) for s in jv]
        assert tv == jv, f.name
    assert t.dtype == torch.bfloat16 and t.use_kernels


def test_init_params_distributions():
    """The port's own init draws JAX's distributions: truncated normal at
    +-3 with std 1/sqrt(fan_in), the SSM constants, zero norms."""
    cfg = dataclasses.replace(tconfigs.get_smoke_config("zamba2-1.2b"),
                              d_model=256, dtype=torch.float32)
    m = TM.Model(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(0))
    w = m.layers[0].in_proj
    std = 1 / np.sqrt(cfg.d_model)
    assert abs(float(w.std()) / std - 0.9866) < 0.02  # truncated at 3 sigma
    assert float(w.abs().max()) <= 3 * std + 1e-6
    conv = m.layers[0].conv_w
    assert float(conv.abs().max()) <= 3 * 0.5 / 2 + 1e-6
    lay = m.layers[1]
    np.testing.assert_allclose(lay.A_log.numpy(),
                               np.log(np.linspace(1, 16, lay.A_log.numel())),
                               rtol=1e-6)
    assert float(lay.dt_bias.max()) == float(lay.dt_bias.min()) == -2.0
    assert float(lay.D_skip.min()) == 1.0 and float(lay.gnorm.abs().max()) == 0
    assert float(m.final_norm.abs().max()) == 0
    assert float(m.shared.ln1.abs().max()) == 0


def test_shared_block_is_one_parameter_set():
    cfg = tconfigs.get_smoke_config("zamba2-1.2b")
    m = TM.Model(cfg, device="meta")
    names = [n for n, _ in m.named_parameters()]
    assert sum(n.startswith("shared.") for n in names) == 9
    assert not any(".shared" in n for n in names)
    kinds = [layer.spec.kind for layer in m.layers]
    assert kinds == ["mamba", "mamba_shared_attn"] * 2 + ["mamba"]


def test_smollm_ties_its_embeddings():
    m = TM.Model(tconfigs.get_config("smollm-135m"), device="meta")
    assert m.lm_head is None


def test_converter_rejects_a_mismatched_tree():
    jcfg, tcfg = _configs("smollm-135m", "float32")
    params = M.init_params(jcfg, jax.random.PRNGKey(0))
    params["groups"][0] = dict(params["groups"][0])
    del params["groups"][0]["wq"]
    with pytest.raises(ValueError):
        model_params_from_numpy(tcfg, params, device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_head_tied_as_jax(arch):
    """``lm_head`` exists exactly where JAX's tree has one (gemma3 and
    smollm tie it to the embedding; deepseek-coder and internlm2 do not;
    the embedding-input models have no embedding to tie it to), and so
    does ``embed``."""
    jtree = jax.eval_shape(lambda: M.init_params(jget_smoke(arch),
                                                 jax.random.PRNGKey(0)))
    m = TM.Model(tconfigs.get_smoke_config(arch), device="meta")
    assert (m.lm_head is not None) == ("lm_head" in jtree)
    assert (m.embed is not None) == ("embed" in jtree)
    cfg = tconfigs.get_config(arch)
    full = TM.Model(cfg, device="meta")
    assert (full.lm_head is None) == (cfg.tie_embeddings
                                      and not cfg.embed_inputs)


@pytest.mark.parametrize("arch", ["gemma3-4b", "deepseek-coder-33b"])
def test_each_layer_keeps_its_rope_theta_and_window(arch):
    cfg = tconfigs.get_config(arch)
    jcfg = jget_config(arch)
    m = TM.Model(cfg, device="meta")
    jspecs = list(jcfg.pattern) * jcfg.repeats + list(jcfg.tail)
    assert [(layer.spec.rope_theta, layer.spec.sliding_window)
            for layer in m.layers] == [(s.rope_theta, s.sliding_window)
                                       for s in jspecs]
