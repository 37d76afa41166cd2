"""qwen2-vl-72b [vlm] -- M-RoPE, dynamic resolution.
80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064
[arXiv:2409.12191; hf]

Backbone only: the vision frontend is a stub, so the model takes
precomputed patch / token embeddings (B, S, d_model) and (3, B, S) M-RoPE
position ids (temporal / height / width streams).  M-RoPE sections (16,
24, 24) over the 64 rotary frequency channels.
"""
from repro_torch.models.common import LayerSpec, ModelConfig

_SPEC = LayerSpec("dense", rope_theta=1e6)

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab_size=152064,
    pattern=(_SPEC,),
    repeats=80,
    mrope_sections=(16, 24, 24),
    embed_inputs=True,
)


def smoke_config():
    return ModelConfig(
        name="qwen2-vl-smoke",
        num_layers=3,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        pattern=(_SPEC,),
        repeats=3,
        mrope_sections=(2, 3, 3),
        embed_inputs=True,
    )
