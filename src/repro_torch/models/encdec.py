"""Encoder-decoder family (the SeamlessM4T-medium backbone).

The speech frontend is a stub, as in the JAX package: ``batch['frontend']``
carries precomputed frame embeddings (B, S_enc, frontend_dim), projected
into d_model.  Encoder: a bidirectional self-attention stack; decoder:
causal self-attention, then cross-attention to the encoder's output.  The
cross K/V are computed once at prefill and cached, so decode reaches the
encoder only through them.

Layer weights are stacked on a leading ``L`` axis, as in the JAX package;
each stack is a Python loop over ``torch.unbind`` of its leaves, as
``transformer._stack_dense`` runs the dense one.  Under grad, outside
decode, each block is rematerialised as ``cfg.remat`` says.  On the card
the encoder's self-attention takes the flash kernel bidirectionally and
the decoder's, without a cache, causally, where both lengths are multiples
of 128; cross-attention runs ``layers._gqa_scores_full`` everywhere, as
the JAX package's does.
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from .layers import (_einsum, _gqa_scores_full, apply_mlp, apply_norm,
                     attention, attention_specs, cross_entropy, embed_specs,
                     embed_tokens, lm_logits, make_kv_cache, mlp_specs,
                     norm_specs)
from .param import SpecTree
from .transformer import _maybe_remat, _unstack, frontend_specs


def encdec_specs(cfg: ModelConfig) -> SpecTree:
    Le, Ld = cfg.n_layers, cfg.n_dec_layers
    return {
        "embed": embed_specs(cfg),
        "frontend": frontend_specs(cfg),
        "enc_blocks": {
            "attn_norm": norm_specs(cfg, Le),
            "attn": attention_specs(cfg, Le),
            "mlp_norm": norm_specs(cfg, Le),
            "mlp": mlp_specs(cfg, Le),
        },
        "dec_blocks": {
            "self_norm": norm_specs(cfg, Ld),
            "self_attn": attention_specs(cfg, Ld),
            "cross_norm": norm_specs(cfg, Ld),
            "cross_attn": attention_specs(cfg, Ld),
            "mlp_norm": norm_specs(cfg, Ld),
            "mlp": mlp_specs(cfg, Ld),
        },
        "enc_final_norm": norm_specs(cfg),
        "final_norm": norm_specs(cfg),
    }


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, device=device)[None].expand(B, S)


def _enc_block(pl, x, positions, cfg: ModelConfig):
    h = apply_norm(pl["attn_norm"], x, cfg)
    a, _ = attention(pl["attn"], h, cfg, positions=positions, causal=False)
    x = x + a
    h = apply_norm(pl["mlp_norm"], x, cfg)
    return x + apply_mlp(pl["mlp"], h, cfg)


def _encode(params, frames, cfg: ModelConfig):
    proj = params["frontend"]["proj"]
    fe = frames.to(cfg.dtype)
    dt = torch.promote_types(fe.dtype, proj.dtype)
    x = fe.to(dt) @ proj.to(dt)
    B, S, _ = x.shape
    positions = _positions(B, S, x.device)
    blocks = params["enc_blocks"]
    block = _maybe_remat(_enc_block, cfg, False)
    for pl in _unstack(blocks, blocks["attn"]["wq"].shape[0]):
        x = block(pl, x, positions, cfg)
    return apply_norm(params["enc_final_norm"], x, cfg)


def _cross_kv(pl, enc_out, cfg: ModelConfig):
    k = _einsum("bsd,dhk->bshk", enc_out, pl["cross_attn"]["wk"])
    v = _einsum("bsd,dhk->bshk", enc_out, pl["cross_attn"]["wv"])
    if cfg.qkv_bias:
        k = k + pl["cross_attn"]["bk"]
        v = v + pl["cross_attn"]["bv"]
    return k, v


def _cross_apply(pl, x, ck, cv, cfg: ModelConfig):
    q = _einsum("bsd,dhk->bshk", x, pl["cross_attn"]["wq"])
    if cfg.qkv_bias:
        q = q + pl["cross_attn"]["bq"]
    out = _gqa_scores_full(q, ck, cv, causal=False, q_offset=0,
                           chunk=cfg.chunk_size)
    return _einsum("bshk,hkd->bsd", out, pl["cross_attn"]["wo"])


def _dec_block(pl, x, positions, cache_l, ck, cv, cfg: ModelConfig,
               decode: bool):
    h = apply_norm(pl["self_norm"], x, cfg)
    a, new_cache = attention(pl["self_attn"], h, cfg, positions=positions,
                             cache=cache_l, decode=decode)
    x = x + a
    h = apply_norm(pl["cross_norm"], x, cfg)
    x = x + _cross_apply(pl, h, ck, cv, cfg)
    h = apply_norm(pl["mlp_norm"], x, cfg)
    return x + apply_mlp(pl["mlp"], h, cfg), new_cache


def _decoder(params, tokens, enc_out, cfg: ModelConfig, cache=None,
             decode=False, cross_kv=None):
    """-> (logits, the new self-attention cache or None, the cross K/V
    stacked on the decoder layers, each (Ld, B, S_enc, Hkv, D))."""
    B, S = tokens.shape
    if decode:
        length = cache["length"][0]
        positions = length.reshape(1, 1).expand(B, 1)
    else:
        positions = _positions(B, S, tokens.device)
    x = embed_tokens(params["embed"], tokens, cfg, positions)
    blocks = params["dec_blocks"]
    n_layers = blocks["self_attn"]["wq"].shape[0]
    layers = _unstack(blocks, n_layers)
    if cross_kv is None:
        kv = [_cross_kv(pl, enc_out, cfg) for pl in layers]
        cross_kv = tuple(torch.stack(t) for t in zip(*kv))
    caches = [None] * n_layers if cache is None else _unstack(cache, n_layers)
    block = _maybe_remat(_dec_block, cfg, decode)
    new = []
    for pl, cache_l, ck, cv in zip(layers, caches,
                                   *(torch.unbind(t) for t in cross_kv)):
        x, new_cache = block(pl, x, positions, cache_l, ck, cv, cfg, decode)
        new.append(new_cache)
    if cache is not None:
        cache = {k: torch.stack([c[k] for c in new]) for k in new[0]}
    x = apply_norm(params["final_norm"], x, cfg)
    return lm_logits(params["embed"], x, cfg), cache, cross_kv


# ----------------------------------------------------------------------
# Entry points
# ----------------------------------------------------------------------

def loss_fn(params, batch, cfg: ModelConfig):
    enc_out = _encode(params, batch["frontend"], cfg)
    logits, _, _ = _decoder(params, batch["tokens"], enc_out, cfg)
    return cross_entropy(logits, batch["labels"])


def prefill(params, batch, cfg: ModelConfig, max_len: int):
    """-> (the last position's logits, {"self": the decoder's KV cache of
    ``max_len`` positions, "cross": the cross (K, V)})."""
    enc_out = _encode(params, batch["frontend"], cfg)
    tokens = batch["tokens"]
    cache = make_kv_cache(cfg, tokens.shape[0], max_len,
                          n_layers=cfg.n_dec_layers, dtype=cfg.dtype,
                          device=tokens.device)
    logits, cache, cross_kv = _decoder(params, tokens, enc_out, cfg,
                                       cache=cache)
    return logits[:, -1:], {"self": cache, "cross": cross_kv}


def decode_step(params, batch, cache, cfg: ModelConfig):
    logits, new_self, _ = _decoder(params, batch["tokens"], None, cfg,
                                   cache=cache["self"], decode=True,
                                   cross_kv=cache["cross"])
    return logits, {"self": new_self, "cross": cache["cross"]}
