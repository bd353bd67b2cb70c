"""Moonlight-16B-A3B [hf:moonshotai/Moonlight-16B-A3B; hf]: 48L d_model=2048
16H (kv=16) MoE 64 experts top-6 (+2 shared), expert d_ff=1408,
vocab=163840 — fine-grained DeepSeek-style MoE."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab=163840,
    n_experts=64, top_k=6, n_shared_experts=2,
    norm="rms", mlp_type="swiglu", pos="rope",
)
