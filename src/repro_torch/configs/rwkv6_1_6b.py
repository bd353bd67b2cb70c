"""RWKV-6 Finch 1.6B [arXiv:2404.05892; unverified]: 24L d_model=2048
(attention-free), channel-mix d_ff=7168, vocab=65536 — data-dependent decay,
token shift, head size 64."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b", family="ssm",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=7168, vocab=65536,
    ssm_type="rwkv6", ssm_state=64, ssm_head_dim=64, ssm_expand=1,
    norm="ln", pos="none",
)
