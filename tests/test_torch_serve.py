"""The port's serving engine (``repro_torch.serve``) against
``repro.serve.ServeEngine`` on the same float32 smoke weights and prompts:
identical greedy tokens, the same finished requests, and the runqlat
histogram holding one sample per request; plus the launcher on the CPU."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.models import model as M
from repro.serve import ServeEngine as JaxEngine
from repro_torch import configs as tconfigs
from repro_torch.convert import model_params_from_numpy
from repro_torch.launch import serve as tlaunch
from repro_torch.serve import ServeEngine

STATS_KEYS = {"finished", "avg_latency", "p90_latency", "avg_ttft",
              "runqlat_avg", "runqlat_hist"}


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "smollm-135m", "rwkv6-7b"])
def test_greedy_tokens_match_jax(arch):
    jcfg = dataclasses.replace(jget_smoke(arch), dtype=jnp.float32)
    tcfg = dataclasses.replace(tconfigs.get_smoke_config(arch),
                               dtype=torch.float32)
    params = M.init_params(jcfg, jax.random.PRNGKey(0))
    model = model_params_from_numpy(tcfg, params, device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jcfg.vocab_size, int(rng.integers(4, 16)))
               for _ in range(6)]
    news = [int(n) for n in rng.integers(2, 6, len(prompts))]
    jeng, teng = JaxEngine(jcfg, params, max_batch=4), ServeEngine(
        model, max_batch=4)
    for p, n in zip(prompts, news):
        jeng.submit(p, max_new_tokens=n)
        teng.submit(p, max_new_tokens=n)
    jstats, tstats = jeng.run(), teng.run()
    assert set(tstats) == set(jstats) == STATS_KEYS
    assert tstats["finished"] == jstats["finished"] == len(prompts)
    jtok = {r.uid: r.tokens for r in jeng.finished}
    ttok = {r.uid: r.tokens for r in teng.finished}
    assert ttok == jtok
    assert [len(ttok[i]) for i in range(len(prompts))] == news
    assert teng.runqlat.count == len(prompts)
    assert tstats["runqlat_hist"].sum() == len(prompts)
    for r in teng.finished:
        assert r.arrival <= r.first_token_t <= r.done_t


def test_launcher_serves_on_the_cpu(capsys):
    stats = tlaunch.main(["--arch", "zamba2-1.2b", "--smoke", "--device",
                          "cpu", "--requests", "5", "--new-tokens", "3",
                          "--qps", "1000"])
    assert stats["finished"] == 5
    assert stats["runqlat_hist"].sum() == 5
    assert "[serve] finished=5" in capsys.readouterr().out


def test_launcher_serves_rwkv_on_the_cpu(capsys):
    stats = tlaunch.main(["--arch", "rwkv6-7b", "--smoke", "--device",
                          "cpu", "--requests", "5", "--new-tokens", "3",
                          "--qps", "1000"])
    assert stats["finished"] == 5
    assert stats["runqlat_hist"].sum() == 5
    out = capsys.readouterr().out
    assert "arch=rwkv6-smoke" in out and "[serve] finished=5" in out


def test_launcher_needs_a_card_unless_told_otherwise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        tlaunch.main(["--arch", "zamba2-1.2b", "--smoke"])
