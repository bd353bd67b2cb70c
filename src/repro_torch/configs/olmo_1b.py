"""OLMo-1B [arXiv:2402.00838; hf]: 16L d_model=2048 16H (kv=16) d_ff=8192
vocab=50304 — non-parametric LN, SwiGLU, RoPE, tied embeddings."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b", family="dense",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=8192, vocab=50304,
    norm="ln_nonparam", mlp_type="swiglu", pos="rope", rope_theta=1e4,
    tie_embeddings=True,
)
