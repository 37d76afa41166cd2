"""zamba2-1.2b [hybrid] -- Mamba2 backbone + shared attention blocks.
38L d_model=2048 32H (kv=32, MHA) d_ff=8192 ssm_state=64 vocab=32000
[arXiv:2411.15242; hf]

Pattern: 6 groups of (5 mamba + 1 mamba-with-shared-attention) + 2 mamba
tail = 38 mamba layers; the shared attention+MLP block (one parameter
set, reused at each application) fires 6 times.
"""
from repro_torch.models.common import LayerSpec, ModelConfig

_M = LayerSpec("mamba")
_MS = LayerSpec("mamba_shared_attn", rope_theta=1e4)

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=32000,
    pattern=(_M, _M, _M, _M, _M, _MS),
    repeats=6,
    tail=(_M, _M),
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_conv=4,
    shared_attn=True,
)


def smoke_config():
    return ModelConfig(
        name="zamba2-smoke",
        num_layers=5,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        pattern=(_M, _MS),
        repeats=2,
        tail=(_M,),
        ssm_state=16,
        ssm_expand=2,
        ssm_head_dim=16,
        ssm_conv=4,
        shared_attn=True,
    )
