"""Zamba2-7B [arXiv:2411.15242; unverified]: 81L d_model=3584 Mamba2
backbone (ssm_state=64, expand=2, head 64) + SHARED attention block
(32H kv=32, d_ff=14336) applied every 6 layers — the shared block reuses
one set of weights at every application (the Zamba trick)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32,
    d_ff=14336, vocab=32000,
    ssm_type="mamba2", ssm_state=64, ssm_expand=2, ssm_head_dim=64,
    conv_width=4, attn_every=6,
    norm="rms", mlp_type="swiglu", pos="rope",
)
