"""The port's synthetic data pipeline (``repro_torch.data``) against
``repro.data``: the batches equal JAX's bit for bit (tokens, labels,
mask, embeddings, M-RoPE positions) over seeds, steps, host shards and
shapes, plus the behaviours of ``tests/test_data_serve.py:11-50`` under
the same names."""
import numpy as np
import pytest

from repro.data import SyntheticLM as JSyntheticLM
from repro_torch.data import Prefetcher, SyntheticLM


@pytest.mark.parametrize("kw", [
    dict(vocab_size=256, seq_len=32, global_batch=4, seed=1),
    dict(vocab_size=49152, seq_len=128, global_batch=8, seed=0),
    dict(vocab_size=256, seq_len=32, global_batch=8, seed=1, num_hosts=2,
         host_id=1),
    dict(vocab_size=64, seq_len=16, global_batch=2, seed=3, embed_dim=32),
    dict(vocab_size=256, seq_len=16, global_batch=2, seed=0, embed_dim=32,
         mrope=True),
])
def test_batches_equal_jax_bit_for_bit(kw):
    mine, theirs = SyntheticLM(**kw), JSyntheticLM(**kw)
    np.testing.assert_array_equal(mine.probs, theirs.probs)
    for step in (0, 1, 17):
        a, b = mine.batch(step), theirs.batch(step)
        assert sorted(a) == sorted(b)
        for k in b:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k])


def test_data_deterministic_per_step():
    ds = SyntheticLM(256, 32, 4, seed=1)
    a = ds.batch(5)
    b = ds.batch(5)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    c = ds.batch(6)
    assert not np.array_equal(a["tokens"], c["tokens"])


def test_data_host_shards_differ_and_partition():
    d0 = SyntheticLM(256, 32, 8, seed=1, num_hosts=2, host_id=0)
    d1 = SyntheticLM(256, 32, 8, seed=1, num_hosts=2, host_id=1)
    b0, b1 = d0.batch(0), d1.batch(0)
    assert b0["tokens"].shape == (4, 32)
    assert not np.array_equal(b0["tokens"], b1["tokens"])


def test_labels_are_shifted_tokens():
    ds = SyntheticLM(256, 16, 2, seed=0)
    b = ds.batch(0)
    np.testing.assert_array_equal(b["labels"][:, :-1], b["tokens"][:, 1:])


def test_embed_frontend_outputs():
    ds = SyntheticLM(256, 16, 2, seed=0, embed_dim=32, mrope=True)
    b = ds.batch(0)
    assert b["embeds"].shape == (2, 16, 32)
    assert b["positions"].shape == (3, 2, 16)


def test_prefetcher_in_order():
    ds = SyntheticLM(256, 16, 2, seed=0)
    pf = Prefetcher(ds, start_step=0, depth=2)
    try:
        b0 = pf.next()
        b1 = pf.next()
        np.testing.assert_array_equal(b0["tokens"], ds.batch(0)["tokens"])
        np.testing.assert_array_equal(b1["tokens"], ds.batch(1)["tokens"])
    finally:
        pf.close()


def test_prefetcher_starts_where_asked():
    ds = SyntheticLM(256, 16, 2, seed=0)
    pf = Prefetcher(ds, start_step=7, depth=3)
    try:
        for step in (7, 8, 9, 10):
            np.testing.assert_array_equal(pf.next()["tokens"],
                                          ds.batch(step)["tokens"])
    finally:
        pf.close()
