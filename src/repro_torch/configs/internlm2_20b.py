"""internlm2-20b [dense] -- GQA.
48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92544
[arXiv:2403.17297; hf]
"""
from repro_torch.models.common import LayerSpec, ModelConfig

_SPEC = LayerSpec("dense", rope_theta=1e6)

CONFIG = ModelConfig(
    name="internlm2-20b",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92544,
    pattern=(_SPEC,),
    repeats=48,
)


def smoke_config():
    return ModelConfig(
        name="internlm2-20b-smoke",
        num_layers=3,
        d_model=48,
        num_heads=6,
        num_kv_heads=2,
        head_dim=8,
        d_ff=128,
        vocab_size=256,
        pattern=(_SPEC,),
        repeats=3,
    )
