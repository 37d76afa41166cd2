"""Architecture configs of the port (port of ``repro.configs``).

Each module exports ``CONFIG`` (full size) and ``smoke_config()`` (a
reduced config of the same family for CPU tests).  The port carries all
ten architectures of the JAX package, in its order.
"""
from __future__ import annotations

import importlib

ARCHS = ["rwkv6_7b", "qwen3_moe_235b_a22b", "dbrx_132b", "qwen2_vl_72b",
         "gemma3_4b", "deepseek_coder_33b", "internlm2_20b", "smollm_135m",
         "zamba2_1p2b", "hubert_xlarge"]

_ALIASES = {
    "rwkv6-7b": "rwkv6_7b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "dbrx-132b": "dbrx_132b",
    "qwen2-vl-72b": "qwen2_vl_72b",
    "gemma3-4b": "gemma3_4b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "internlm2-20b": "internlm2_20b",
    "smollm-135m": "smollm_135m",
    "zamba2-1.2b": "zamba2_1p2b",
    "hubert-xlarge": "hubert_xlarge",
}


def canonical(name: str) -> str:
    return _ALIASES.get(name, name.replace("-", "_").replace(".", "p"))


def _module(name: str):
    arch = canonical(name)
    if arch not in ARCHS:
        raise ValueError(f"unknown architecture {name!r}")
    return importlib.import_module(f"repro_torch.configs.{arch}")


def get_config(name: str):
    return _module(name).CONFIG


def get_smoke_config(name: str):
    return _module(name).smoke_config()
