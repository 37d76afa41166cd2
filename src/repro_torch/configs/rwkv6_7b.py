"""rwkv6-7b [ssm] -- Finch, data-dependent decay, attention-free.
32L d_model=4096 d_ff=14336 vocab=65536; head_size 64 -> 64 heads.
[arXiv:2404.05892; hf]
"""
from repro_torch.models.common import LayerSpec, ModelConfig

_SPEC = LayerSpec("rwkv")

CONFIG = ModelConfig(
    name="rwkv6-7b",
    num_layers=32,
    d_model=4096,
    num_heads=64,        # head_size 64
    num_kv_heads=64,
    head_dim=64,
    d_ff=14336,
    vocab_size=65536,
    pattern=(_SPEC,),
    repeats=32,
)


def smoke_config():
    return ModelConfig(
        name="rwkv6-smoke",
        num_layers=3,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        pattern=(_SPEC,),
        repeats=3,
    )
