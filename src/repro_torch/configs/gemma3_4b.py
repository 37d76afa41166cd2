"""gemma3-4b [dense] -- 5:1 local:global attention, 128k context.
34L d_model=2560 8H (GQA kv=4) d_ff=10240 vocab=262144
[hf:google/gemma-3-1b-pt; unverified]

head_dim=256 per the public gemma-3 configs (not d_model/num_heads).
Pattern: groups of (5 x sliding-window-1024 local @ theta 10k,
1 x global @ theta 1M); 34 = 5 groups of 6 + 4 local tail.
"""
from repro_torch.models.common import LayerSpec, ModelConfig

_LOCAL = LayerSpec("dense", sliding_window=1024, rope_theta=1e4)
_GLOBAL = LayerSpec("dense", sliding_window=0, rope_theta=1e6)

CONFIG = ModelConfig(
    name="gemma3-4b",
    num_layers=34,
    d_model=2560,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=10240,
    vocab_size=262144,
    pattern=(_LOCAL, _LOCAL, _LOCAL, _LOCAL, _LOCAL, _GLOBAL),
    repeats=5,
    tail=(_LOCAL, _LOCAL, _LOCAL, _LOCAL),
    tie_embeddings=True,
)


def smoke_config():
    local = LayerSpec("dense", sliding_window=32, rope_theta=1e4)
    glob = LayerSpec("dense", sliding_window=0, rope_theta=1e6)
    return ModelConfig(
        name="gemma3-4b-smoke",
        num_layers=8,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        pattern=(local, local, glob),
        repeats=2,
        tail=(local, local),
    )
