"""Qwen2-72B [arXiv:2407.10671; hf]: 80L d_model=8192 64H (GQA kv=8)
d_ff=29568 vocab=152064 — QKV bias, RMSNorm, SwiGLU, RoPE theta=1e6."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-72b", family="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=29568, vocab=152064,
    norm="rms", mlp_type="swiglu", pos="rope", rope_theta=1e6,
    qkv_bias=True,
)
