"""SeamlessM4T-medium [arXiv:2308.11596; hf]: enc-dec, 12L encoder + 12L
decoder interpretation of "12L", d_model=1024 16H (kv=16) d_ff=4096
vocab=256206 — speech frontend is a STUB: input_specs() supplies
precomputed frame embeddings (B, frames, frontend_dim)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="encdec",
    n_layers=12, n_dec_layers=12, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab=256206,
    norm="ln", mlp_type="gelu", pos="rope",
    frontend="audio", frontend_dim=1024, frontend_len=0,  # len = seq
)
