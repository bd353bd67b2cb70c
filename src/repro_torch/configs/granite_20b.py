"""Granite-20B code model [arXiv:2405.04324; hf]: 52L d_model=6144 48H
(MQA kv=1) d_ff=24576 vocab=49152 — GPT-BigCode style: learned positions,
LayerNorm, GELU MLP, QKV bias."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b", family="dense",
    n_layers=52, d_model=6144, n_heads=48, n_kv_heads=1,
    d_ff=24576, vocab=49152,
    norm="ln", mlp_type="gelu", pos="learned", qkv_bias=True,
)
