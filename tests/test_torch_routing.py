"""``repro_torch.models.routing.PinnedRouting`` under remat, on the qwen3-moe
and dbrx smoke configs in float32 on the CPU.

``train_loss`` checkpoints every scanned layer, so the backward recomputes
each layer's forward, last layer first: the calls of ``moe_route`` come
in the order layer 0, 1, 2, then 2, 1, 0.  A pin that replayed its
recorded routings by call order would hand each recompute another layer's
experts; the pin keys them by the layer's router, and these tests hold
that: a record-then-replay leaves the gradients bit for bit as they are
without a pin, and a replay after a perturbed forward takes, in every
call, the experts recorded for that call's own layer, and counts the
tokens it moved.
"""
import dataclasses

import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch.models import ffn
from repro_torch.models import model as TM
from repro_torch.models.routing import PinnedRouting

ARCHS = ["qwen3-moe-235b-a22b", "dbrx-132b"]
B, T = 2, 64


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the module's tests (the suite runs several
    worker processes, and their small CPU kernels would spin against each
    other at one thread a core each)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model_and_batch(arch):
    cfg = dataclasses.replace(tconfigs.get_smoke_config(arch),
                              dtype=torch.float32)
    model = TM.Model(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(0))
    model.requires_grad_(True)
    g = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab_size, (B, T), generator=g)
             for k in ("tokens", "labels")}
    return model, batch


def _grads(model, batch):
    loss, _ = TM.train_loss(model, batch, remat=True)
    return loss.detach(), torch.autograd.grad(loss, list(model.parameters()))


@pytest.mark.parametrize("arch", ARCHS)
def test_record_then_replay_keeps_the_gradients_bit_for_bit(arch):
    """Unpinned, recording (whose recomputes already take the recorded
    experts) and replaying: the same loss and gradients, bit for bit, and
    no token moved in the nine calls that took a recorded routing (the
    recording run's three recomputes, the replay's three forwards and
    three recomputes)."""
    model, batch = _model_and_batch(arch)
    loss0, g0 = _grads(model, batch)
    with PinnedRouting() as pin:
        loss1, g1 = _grads(model, batch)
        pin.replay()
        loss2, g2 = _grads(model, batch)
    assert ffn.moe_route is pin.real
    assert torch.equal(loss0, loss1) and torch.equal(loss0, loss2)
    for a, b, c in zip(g0, g1, g2):
        assert torch.equal(a, b) and torch.equal(a, c)
    n = model.cfg.num_layers
    assert len(pin.recorded) == n
    assert pin.tokens == 3 * n * B * T and pin.differ == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_replay_after_a_perturbed_forward_takes_each_layers_own_experts(
        arch):
    """Record, perturb every layer's ``wq`` by 5%, replay: the calls come
    as layer 0, 1, 2 and then 2, 1, 0 (the recomputes), each returns the
    experts recorded for its own router, and the tokens whose own top-k
    set moved are counted."""
    model, batch = _model_and_batch(arch)
    routers = [layer.router.data_ptr() for layer in model.layers]
    log = []
    with PinnedRouting() as pin:
        _grads(model, batch)
        assert pin.differ == 0
        with torch.no_grad():
            g = torch.Generator().manual_seed(2)
            for layer in model.layers:
                layer.wq.mul_(1 + 0.05 * torch.randn(layer.wq.shape,
                                                     generator=g))
        pin.replay()
        pinned = pin.route

        def spy(x, router, **kw):
            r = pinned(x, router, **kw)
            log.append((router.data_ptr(), r["expert_idx"]))
            return r

        ffn.moe_route = spy
        loss, grads = _grads(model, batch)
    assert [key for key, _ in log] == routers + routers[::-1]
    for key, idx in log:
        assert torch.equal(idx.reshape(B, T, -1), pin.recorded[key])
    # the recording run's recomputes and the replay's forward and
    # recomputes
    assert pin.tokens == 3 * len(routers) * B * T
    assert 0 < pin.differ < pin.tokens
    assert torch.isfinite(loss)
    assert all(torch.isfinite(x).all() for x in grads)


def test_replay_refuses_a_router_it_never_recorded():
    model, batch = _model_and_batch("qwen3-moe-235b-a22b")
    with PinnedRouting() as pin:
        pin.replay()
        with pytest.raises(KeyError, match="no routing recorded"):
            _grads(model, batch)
