"""dbrx-132b [moe] -- 16 experts top-4, fine-grained.
40L d_model=6144 48H (GQA kv=8) d_ff=10752 (per-expert) vocab=100352
[hf:databricks/dbrx-base; unverified]
"""
from repro_torch.models.common import LayerSpec, ModelConfig

_SPEC = LayerSpec("moe", rope_theta=5e5)

CONFIG = ModelConfig(
    name="dbrx-132b",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=10752,
    vocab_size=100352,
    num_experts=16,
    experts_per_tok=4,
    pattern=(_SPEC,),
    repeats=40,
)


def smoke_config():
    return ModelConfig(
        name="dbrx-smoke",
        num_layers=3,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=96,
        vocab_size=256,
        num_experts=4,
        experts_per_tok=2,
        pattern=(_SPEC,),
        repeats=3,
    )
