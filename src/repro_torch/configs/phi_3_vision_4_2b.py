"""Phi-3-vision-4.2B [hf:microsoft/Phi-3-vision-128k-instruct; hf]:
32L d_model=3072 32H (kv=32) d_ff=8192 vocab=32064 — phi3-mini backbone;
the CLIP frontend is a STUB: input_specs() supplies precomputed patch
embeddings (B, n_patches, frontend_dim)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b", family="dense",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab=32064,
    norm="rms", mlp_type="swiglu", pos="rope",
    frontend="vision", frontend_dim=1024, frontend_len=576,
)
