"""Assigned architecture configs (``--arch <id>``).

Each entry is the exact published configuration from the task assignment;
sources are cited per file.  ``REGISTRY[name]`` -> :class:`ModelConfig`.
"""
from __future__ import annotations

from .base import ModelConfig
from .olmo_1b import CONFIG as olmo_1b
from .granite_20b import CONFIG as granite_20b
from .qwen2_72b import CONFIG as qwen2_72b
from .llama3_8b import CONFIG as llama3_8b
from .moonshot_v1_16b_a3b import CONFIG as moonshot_v1_16b_a3b
from .dbrx_132b import CONFIG as dbrx_132b
from .rwkv6_1_6b import CONFIG as rwkv6_1_6b
from .phi_3_vision_4_2b import CONFIG as phi_3_vision_4_2b
from .seamless_m4t_medium import CONFIG as seamless_m4t_medium
from .zamba2_7b import CONFIG as zamba2_7b

REGISTRY: dict[str, ModelConfig] = {
    c.name: c for c in [
        olmo_1b, granite_20b, qwen2_72b, llama3_8b, moonshot_v1_16b_a3b,
        dbrx_132b, rwkv6_1_6b, phi_3_vision_4_2b, seamless_m4t_medium,
        zamba2_7b,
    ]
}


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(REGISTRY)}")
    return REGISTRY[name]


__all__ = ["ModelConfig", "REGISTRY", "get_config"]
