"""deepseek-coder-33b [dense] -- llama-arch.
62L d_model=7168 56H (GQA kv=8) d_ff=19200 vocab=32256
[arXiv:2401.14196; hf]
"""
from repro_torch.models.common import LayerSpec, ModelConfig

_SPEC = LayerSpec("dense", rope_theta=1e5)

CONFIG = ModelConfig(
    name="deepseek-coder-33b",
    num_layers=62,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=19200,
    vocab_size=32256,
    pattern=(_SPEC,),
    repeats=62,
)


def smoke_config():
    return ModelConfig(
        name="deepseek-coder-33b-smoke",
        num_layers=4,
        d_model=64,
        num_heads=8,
        num_kv_heads=2,
        head_dim=8,
        d_ff=160,
        vocab_size=256,
        pattern=(_SPEC,),
        repeats=4,
    )
