"""smollm-135m [dense] -- llama-arch small.
30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152
[hf:HuggingFaceTB/SmolLM-135M; hf]
"""
from repro_torch.models.common import LayerSpec, ModelConfig

_SPEC = LayerSpec("dense", rope_theta=1e4)

CONFIG = ModelConfig(
    name="smollm-135m",
    num_layers=30,
    d_model=576,
    num_heads=9,
    num_kv_heads=3,
    head_dim=64,
    d_ff=1536,
    vocab_size=49152,
    pattern=(_SPEC,),
    repeats=30,
    tie_embeddings=True,
)


def smoke_config():
    return ModelConfig(
        name="smollm-135m-smoke",
        num_layers=4,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        pattern=(_SPEC,),
        repeats=4,
    )
