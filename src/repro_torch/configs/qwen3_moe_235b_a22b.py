"""qwen3-moe-235b-a22b [moe] -- 128 experts top-8.
94L d_model=4096 64H (GQA kv=4) d_ff=1536 (per-expert) vocab=151936
[hf:Qwen/Qwen3-30B-A3B; hf]
"""
from repro_torch.models.common import LayerSpec, ModelConfig

_SPEC = LayerSpec("moe", rope_theta=1e6)

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    head_dim=64,
    d_ff=1536,
    vocab_size=151936,
    num_experts=128,
    experts_per_tok=8,
    pattern=(_SPEC,),
    repeats=94,
)


def smoke_config():
    return ModelConfig(
        name="qwen3-moe-smoke",
        num_layers=3,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=64,
        vocab_size=256,
        num_experts=8,
        experts_per_tok=2,
        pattern=(_SPEC,),
        repeats=3,
    )
