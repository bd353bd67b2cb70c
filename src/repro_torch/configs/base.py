"""Model/config system for the assigned architectures.

One frozen dataclass covers all ten families; family-specific fields are
inert elsewhere.  ``reduced()`` derives the CPU smoke-test config (same
family/topology, tiny widths).  A copy of the JAX package's
``configs/base.py`` as data; ``dtype`` (the activation dtype) is a torch
dtype.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    head_dim: int | None = None    # default d_model // n_heads
    qkv_bias: bool = False
    mlp_type: str = "swiglu"       # swiglu | gelu
    norm: str = "rms"              # rms | ln | ln_nonparam
    pos: str = "rope"              # rope | learned | none
    rope_theta: float = 1e4
    tie_embeddings: bool = False

    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25

    # SSM / hybrid
    ssm_type: str | None = None    # rwkv6 | mamba2
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    conv_width: int = 4
    attn_every: int = 0            # >0: shared attention block cadence

    # encoder-decoder
    n_dec_layers: int = 0          # >0 → enc-dec; n_layers = encoder depth

    # modality frontend stub (precomputed embeddings via input_specs)
    frontend: str | None = None    # vision | audio
    frontend_dim: int = 0
    frontend_len: int = 0

    # numerics / training
    dtype: Any = torch.bfloat16
    remat: str = "full"            # none | full | dots
    max_learned_pos: int = 8192
    chunk_size: int = 256          # linear-scan / flash block size
    # Fully unroll every internal lax.scan (layers, attention query blocks,
    # recurrence chunks).  Used by the dry-run's *cost* compiles: XLA's
    # cost_analysis counts while-loop bodies once, so exact FLOP/byte/
    # collective totals come from small-depth unrolled compiles that are
    # linearly extrapolated in depth (launch/dryrun.py).
    scan_unroll: bool = False

    # Embedding/head tables are allocated padded to a multiple of this so
    # the vocab dim is tensor-parallel-divisible (e.g. seamless's 256206
    # is not 16-divisible and would replicate a (B,S,V) logits tensor).
    # Logits at pad positions are masked to -inf; published vocab size is
    # unchanged.
    pad_vocab_to: int = 64

    # ------------------------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        p = self.pad_vocab_to
        return ((self.vocab + p - 1) // p) * p

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def is_encdec(self) -> bool:
        return self.n_dec_layers > 0

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic(self) -> bool:
        """Eligible for the long_500k cell (SSM / hybrid)."""
        return self.family in ("ssm", "hybrid")

    @property
    def ssm_heads(self) -> int:
        return (self.d_model * self.ssm_expand) // self.ssm_head_dim

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        kw = dict(
            n_layers=min(self.n_layers, 2),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 4) or 1,
            head_dim=16,
            d_ff=max(32, 128 if not self.n_experts else 32),
            vocab=128,
            max_learned_pos=128,
            chunk_size=16,
        )
        if self.n_experts:
            kw.update(n_experts=min(self.n_experts, 4),
                      top_k=min(self.top_k, 2))
        if self.ssm_type:
            kw.update(ssm_state=16, ssm_head_dim=16, conv_width=2)
        if self.attn_every:
            kw.update(attn_every=2, n_layers=4)
        if self.is_encdec:
            kw.update(n_dec_layers=2)
        if self.frontend:
            kw.update(frontend_dim=32, frontend_len=8)
        return self.replace(**kw)

    # -- parameter accounting (for roofline MODEL_FLOPS) ----------------
    def param_counts(self) -> dict[str, float]:
        d, hd = self.d_model, self.head_dim_
        q = self.n_heads * hd
        kv = self.n_kv_heads * hd
        attn = d * q + 2 * d * kv + q * d
        if self.mlp_type == "swiglu":
            mlp_dense = 3 * d * self.d_ff
        else:
            mlp_dense = 2 * d * self.d_ff
        out: dict[str, float] = {}
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        if self.family in ("dense", "encdec"):
            layers = self.n_layers + self.n_dec_layers
            cross = self.n_dec_layers * attn
            out["total"] = layers * (attn + mlp_dense) + cross + emb
            out["active"] = out["total"]
        elif self.family == "moe":
            experts = self.n_experts * mlp_dense + \
                self.n_shared_experts * mlp_dense + d * self.n_experts
            act = (self.top_k + self.n_shared_experts) * mlp_dense
            out["total"] = self.n_layers * (attn + experts) + emb
            out["active"] = self.n_layers * (attn + act + d * self.n_experts) + emb
        elif self.family in ("ssm", "hybrid"):
            if self.ssm_type == "rwkv6":
                di = d
                mix = 4 * d * di + di * d + d * 32 * 2  # r,k,v,g,w + out + lora
                ffn = 2 * d * self.d_ff
                per_layer = mix + ffn
            else:  # mamba2
                di = d * self.ssm_expand
                per_layer = d * (2 * di + 2 * self.ssm_heads *
                                 self.ssm_state // max(1, self.ssm_heads) +
                                 self.ssm_heads) + di * d + \
                    2 * self.ssm_state * di
            n_attn = (self.n_layers // self.attn_every) if self.attn_every \
                else 0
            shared = (attn + mlp_dense) if self.attn_every else 0
            out["total"] = self.n_layers * per_layer + shared + emb
            out["active"] = out["total"] if not self.attn_every else \
                self.n_layers * per_layer + n_attn * (attn + mlp_dense) + emb
        else:
            raise ValueError(self.family)
        return out
