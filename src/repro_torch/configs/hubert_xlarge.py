"""hubert-xlarge [audio] -- encoder-only, w2v2-style backbone.
48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504 (masked-unit targets)
[arXiv:2106.07447; unverified]

Backbone only: the CNN waveform frontend is a stub, so the model takes
precomputed frame embeddings (B, S, d_model).  Bidirectional (non-causal)
attention, rotated by RoPE at the default theta as in the JAX package; no
decode path (encoder-only).  Its objective is masked-unit prediction over
the 504 cluster targets.
"""
from repro_torch.models.common import LayerSpec, ModelConfig

_SPEC = LayerSpec("enc")

CONFIG = ModelConfig(
    name="hubert-xlarge",
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab_size=504,
    pattern=(_SPEC,),
    repeats=48,
    causal=False,
    embed_inputs=True,
)


def smoke_config():
    return ModelConfig(
        name="hubert-smoke",
        num_layers=3,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=64,
        pattern=(_SPEC,),
        repeats=3,
        causal=False,
        embed_inputs=True,
    )
