"""The two embedding-input families of the port against ``repro.models``:
qwen2-vl-72b's M-RoPE (``apply_rope`` with (3, B, S) positions split into
sections) and its prefill at image-grid positions, hubert-xlarge's
non-causal encoder forward, the converter on a tree without ``embed``,
and the serving entry points refusing what JAX's engine cannot serve.
Smoke configs (3 layers, hd 16), weights carried from JAX's
``init_params`` by ``model_params_from_numpy``; tolerances as
``tests/test_torch_model.py``'s."""
import dataclasses
import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models import model as M
from repro_torch import configs as tconfigs
from repro_torch.convert import model_params_from_numpy
from repro_torch.launch import serve as tlaunch
from repro_torch.models import attention as tattn
from repro_torch.models import model as TM
from repro_torch.serve import ServeEngine

from test_torch_model import _build, _close, _jax_run, grid_positions

ROOT = pathlib.Path(__file__).resolve().parents[1]
B, T = 2, 128


@pytest.mark.parametrize("hd,sections", [(16, (2, 3, 3)),
                                         (128, (16, 24, 24))])
def test_mrope_matches_jax_with_three_streams(hd, sections):
    """Three position streams that differ (an image grid): the rotation
    matches JAX's ``apply_rope`` channel for channel."""
    rng = np.random.default_rng(hd)
    x = rng.standard_normal((B, 80, 3, hd)).astype(np.float32)
    pos = grid_positions(80, 6)
    assert not (pos[0] == pos[1]).all() and not (pos[1] == pos[2]).all()
    want = jattn.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6, sections)
    got = tattn.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6,
                           sections)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mrope_with_equal_streams_is_plain_rope_bit_for_bit(dtype):
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((B, 40, 4, 128)).astype(
        np.float32)).to(dtype)
    pos = torch.arange(7, 47)[None].expand(B, 40)
    plain = tattn.apply_rope(x, pos, 1e6)
    mrope = tattn.apply_rope(x, pos[None].expand(3, B, 40), 1e6,
                             (16, 24, 24))
    assert torch.equal(plain, mrope)


def test_mrope_refuses_positions_or_sections_that_do_not_fit():
    x = torch.zeros((1, 4, 2, 16))
    pos = torch.zeros((3, 1, 4), dtype=torch.long)
    with pytest.raises(ValueError):
        tattn.apply_rope(x, pos[0], 1e4, (2, 3, 3))
    with pytest.raises(ValueError):
        tattn.apply_rope(x, pos, 1e4, (2, 3, 2))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qwen2vl_prefill_at_image_grid_positions_matches_jax(dtype):
    """Prefill logits at image-grid positions against JAX's; the same
    embeddings at equal-stream positions give other logits, so the
    sections are read."""
    jcfg, tcfg, params, model = _build("qwen2-vl-72b", dtype)
    e = np.random.default_rng(9).standard_normal(
        (B, T, jcfg.d_model)).astype(np.float32)
    pos = grid_positions(T, 8)
    want, _ = _jax_run(lambda p, b: M.prefill(jcfg, p, b), params,
                       {"embeds": jnp.asarray(e),
                        "positions": jnp.asarray(pos)})
    got, cache = model.prefill(embeds=torch.from_numpy(e),
                               positions=torch.from_numpy(pos))
    _close(got, want, dtype, "qwen2-vl grid prefill logits")
    assert cache.len == T
    flat, _ = model.prefill(embeds=torch.from_numpy(e))
    assert float((flat.float() - got.float()).abs().max()) > 0.05


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hubert_forward_logits_match_jax(dtype):
    """Every frame's logits of the non-causal encoder against JAX's
    ``_logits(_run_layers(..., TRAIN))``."""
    jcfg, tcfg, params, model = _build("hubert-xlarge", dtype)
    e = np.random.default_rng(11).standard_normal(
        (B, T, jcfg.d_model)).astype(np.float32)

    def fwd(p, emb):
        x, pos = M._embed_in(jcfg, p, {"embeds": emb})
        h, _ = M._run_layers(jcfg, p, x, pos, "train")
        return M._logits(jcfg, p, h)

    want = _jax_run(fwd, params, jnp.asarray(e))
    got = model(embeds=torch.from_numpy(e))
    assert got.shape == (B, T, jcfg.vocab_size)
    _close(got, want, dtype, "hubert forward logits")


def test_hubert_attends_both_ways():
    """A later frame moves an earlier frame's logits, and a causal run of
    the same weights differs: the flag reaches the attention."""
    _, tcfg, _, model = _build("hubert-xlarge", "float32")
    e = torch.from_numpy(np.random.default_rng(12).standard_normal(
        (B, 64, tcfg.d_model)).astype(np.float32))
    base = model(embeds=e)
    moved = e.clone()
    moved[:, -1] += 1.0
    assert float((model(embeds=moved)[:, 0] - base[:, 0]).abs().max()) > 1e-3
    model.cfg = dataclasses.replace(tcfg, causal=True)
    causal = model(embeds=e)
    model.cfg = tcfg
    assert float((causal - base).abs().max()) > 1e-3


def test_hubert_prefill_last_logits_equal_the_forward_last_row():
    _, tcfg, _, model = _build("hubert-xlarge", "float32")
    e = torch.from_numpy(np.random.default_rng(13).standard_normal(
        (B, 64, tcfg.d_model)).astype(np.float32))
    last, cache = model.prefill(embeds=e)
    np.testing.assert_allclose(last.numpy(), model(embeds=e)[:, -1].numpy(),
                               rtol=1e-5, atol=1e-5)
    assert cache.len == 64


def test_entry_points_take_the_input_their_config_names():
    _, tcfg, _, model = _build("qwen2-vl-72b", "float32")
    with pytest.raises(ValueError):
        model(torch.zeros((B, 4), dtype=torch.long))
    with pytest.raises(ValueError):
        model(embeds=torch.zeros((B, 4, tcfg.d_model)),
              positions=torch.zeros((3, B, 5), dtype=torch.long))
    _, scfg, _, smol = _build("smollm-135m", "float32")
    with pytest.raises(ValueError):
        smol(embeds=torch.zeros((B, 4, scfg.d_model)))


@pytest.mark.parametrize("arch", ["qwen2-vl-72b", "hubert-xlarge"])
def test_converter_carries_a_tree_without_embed(arch):
    jcfg, tcfg, params, model = _build(arch, "float32")
    assert "embed" not in params and model.embed is None
    np.testing.assert_array_equal(model.lm_head.numpy(),
                                  np.asarray(params["lm_head"]))
    stray = dict(params, embed=np.zeros((jcfg.vocab_size, jcfg.d_model),
                                        np.float32))
    with pytest.raises(ValueError):
        model_params_from_numpy(tcfg, stray, device="cpu")


def test_converter_refuses_a_tree_without_the_embed_a_model_has():
    jcfg, tcfg, params, _ = _build("smollm-135m", "float32")
    params = {k: v for k, v in params.items() if k != "embed"}
    with pytest.raises(ValueError):
        model_params_from_numpy(tcfg, params, device="cpu")


def _demo():
    path = ROOT / "examples" / "torch_serve_demo.py"
    spec = importlib.util.spec_from_file_location("_demo_refuse", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch", ["qwen2-vl-72b", "hubert-xlarge"])
def test_serving_entry_points_refuse_what_jax_cannot_serve(arch):
    """JAX's launcher exits for an encoder and its engine takes token
    prompts only: the port's launcher and demo exit, its engine raises."""
    with pytest.raises(SystemExit):
        tlaunch.main(["--arch", arch, "--smoke", "--device", "cpu"])
    with pytest.raises(SystemExit):
        _demo().main(["--arch", arch, "--device", "cpu"])
    model = TM.Model(tconfigs.get_smoke_config(arch), device="cpu")
    with pytest.raises(ValueError):
        ServeEngine(model)


def test_full_configs_count_jax_parameters():
    """qwen2-vl-72b: 80 layers of 877.67 M and a 1.246 B head, no
    embedding table; hubert-xlarge 1.259 B."""
    assert TM.num_params(tconfigs.get_config("qwen2-vl-72b")) == \
        71_459_676_160
    assert TM.num_params(tconfigs.get_config("hubert-xlarge")) == \
        1_259_060_480
