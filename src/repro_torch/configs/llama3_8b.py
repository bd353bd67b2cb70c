"""Llama-3-8B [arXiv:2407.21783; unverified]: 32L d_model=4096 32H (GQA kv=8)
d_ff=14336 vocab=128256 — RMSNorm, SwiGLU, RoPE theta=500k."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama3-8b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=128256,
    norm="rms", mlp_type="swiglu", pos="rope", rope_theta=5e5,
)
