"""Decoder-LM assembly for the dense and ssm (RWKV-6) families.

One spec builder and three entry points:

  * ``loss_fn(params, batch, cfg)``            -- the evaluation objective
  * ``prefill(params, batch, cfg, max_len)``   -- build decode caches
  * ``decode_step(params, batch, cache, cfg)`` -- one token for the batch

Layer weights are stacked on a leading ``L`` axis, as in the JAX package;
each layer stack is a Python loop over the layers (``torch.unbind`` of
the stacks, whose gradient is one stack of the per-layer gradients) that
stacks the new per-layer caches (KV caches, or RWKV-6 recurrent states)
back to ``(L, ...)``.  Under grad, outside decode, each block is
rematerialised as ``cfg.remat`` says (``_maybe_remat``).  The moe and
hybrid families are not ported yet (ROADMAP, queue 1 item 7).
"""
from __future__ import annotations

import torch
from torch.utils import checkpoint as ckpt

from ..configs.base import ModelConfig
from . import ssm
from .layers import (apply_mlp, apply_norm, attention, attention_specs,
                     cross_entropy, embed_specs, embed_tokens, lm_logits,
                     make_kv_cache, mlp_specs, norm_specs)
from .param import ParamSpec, SpecTree


def _require_ported(cfg: ModelConfig) -> None:
    if cfg.family == "dense" or (cfg.family == "ssm"
                                 and cfg.ssm_type == "rwkv6"):
        return
    raise NotImplementedError(
        f"repro_torch: the {cfg.family} family ({cfg.name}) is not "
        "ported yet; see ROADMAP.md, queue 1 item 7")


# ----------------------------------------------------------------------
# Spec builders
# ----------------------------------------------------------------------

def frontend_specs(cfg: ModelConfig) -> dict:
    if not cfg.frontend:
        return {}
    return {"proj": ParamSpec((cfg.frontend_dim, cfg.d_model),
                              (None, "embed"))}


def lm_specs(cfg: ModelConfig) -> SpecTree:
    _require_ported(cfg)
    L = cfg.n_layers
    specs: SpecTree = {"embed": embed_specs(cfg)}
    fn = norm_specs(cfg)
    if fn:
        specs["final_norm"] = fn
    if cfg.frontend:
        specs["frontend"] = frontend_specs(cfg)
    if cfg.family == "ssm":
        block = dict(ssm.rwkv6_specs(cfg, L))
        block["tm_norm"] = norm_specs(cfg, L)
        block["cm_norm"] = norm_specs(cfg, L)
    else:
        block = {"attn": attention_specs(cfg, L)}
        an = norm_specs(cfg, L)
        if an:
            block["attn_norm"] = an
            block["mlp_norm"] = norm_specs(cfg, L)
        block["mlp"] = mlp_specs(cfg, L)
    specs["blocks"] = block
    return specs


# ----------------------------------------------------------------------
# Blocks and the stack
# ----------------------------------------------------------------------

def _dense_block(pl, x, positions, cache_l, cfg: ModelConfig, decode: bool):
    h = apply_norm(pl.get("attn_norm", {}), x, cfg)
    a, new_cache = attention(pl["attn"], h, cfg, positions=positions,
                             cache=cache_l, decode=decode)
    x = x + a
    h = apply_norm(pl.get("mlp_norm", {}), x, cfg)
    return x + apply_mlp(pl["mlp"], h, cfg), new_cache


def _rwkv_block(pl, x, state_l, cfg: ModelConfig, decode: bool):
    st, tm_carry, cm_carry = state_l
    h = apply_norm(pl["tm_norm"], x, cfg)
    y, (st2, tm2) = ssm.rwkv6_time_mix(pl, h, tm_carry, cfg, state=st,
                                       decode=decode)
    x = x + y
    h = apply_norm(pl["cm_norm"], x, cfg)
    y, cm2 = ssm.rwkv6_channel_mix(pl, h, cm_carry, cfg, decode=decode)
    return x + y, (st2, tm2, cm2)


def _unstack(tree: dict, n: int) -> list[dict]:
    """The per-layer trees of stacked leaves, by one ``unbind`` a leaf."""
    flat = {k: _unstack(v, n) if isinstance(v, dict) else torch.unbind(v)
            for k, v in tree.items()}
    return [{k: v[l] for k, v in flat.items()} for l in range(n)]


_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
            torch.ops.aten.addmm.default)


def _save_matmuls(ctx, op, *args, **kwargs):
    """The ``dots`` policy: keep matrix products, recompute the rest."""
    return ckpt.CheckpointPolicy.MUST_SAVE if op in _MATMULS else \
        ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _maybe_remat(fn, cfg: ModelConfig, decode: bool):
    """``fn`` rematerialised in the backward as the JAX package's
    ``_maybe_remat``: ``full`` keeps only the block's inputs, ``dots`` also
    the matrix products' outputs, ``none`` everything.  Only under grad and
    outside decode, where there is a backward to serve."""
    if decode or cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    if cfg.remat == "dots":
        def ctx_fn():
            return ckpt.create_selective_checkpoint_contexts(_save_matmuls)
    else:
        ctx_fn = ckpt.noop_context_fn

    def run(*args):
        return ckpt.checkpoint(fn, *args, use_reentrant=False,
                               context_fn=ctx_fn)
    return run


def _stack_dense(params, x, positions, cache, cfg: ModelConfig,
                 decode: bool):
    blocks = params["blocks"]
    n_layers = blocks["attn"]["wq"].shape[0]
    block = _maybe_remat(_dense_block, cfg, decode)
    caches = [None] * n_layers if cache is None else _unstack(cache, n_layers)
    new = []
    for pl, cache_l in zip(_unstack(blocks, n_layers), caches):
        x, new_cache = block(pl, x, positions, cache_l, cfg, decode)
        new.append(new_cache)
    if cache is None:
        return x, None
    return x, {k: torch.stack([c[k] for c in new]) for k in new[0]}


def _stack_rwkv(params, x, state, cfg: ModelConfig, decode: bool):
    """``state`` is (st (L,B,H,K,K), tm carry (L,B,1,D), cm carry
    (L,B,1,D)); returns x and the new state, stacked the same way."""
    blocks = params["blocks"]
    n_layers = blocks["wr"].shape[0]
    block = _maybe_remat(_rwkv_block, cfg, decode)
    new = []
    for pl, state_l in zip(_unstack(blocks, n_layers),
                           zip(*(torch.unbind(s) for s in state))):
        x, state_l = block(pl, x, state_l, cfg, decode)
        new.append(state_l)
    return x, tuple(torch.stack(s) for s in zip(*new))


# ----------------------------------------------------------------------
# Embedding of (tokens [+ frontend]) into the sequence
# ----------------------------------------------------------------------

def embed_input(params, batch, cfg: ModelConfig):
    """Returns (x, positions, n_prefix) where n_prefix is the number of
    frontend positions prepended ahead of the text tokens."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    n_prefix = 0
    xs = []
    if cfg.frontend == "vision" and "frontend" in batch:
        proj = params["frontend"]["proj"]
        fe = batch["frontend"].to(cfg.dtype)
        dt = torch.promote_types(fe.dtype, proj.dtype)
        emb = fe.to(dt) @ proj.to(dt)
        n_prefix = emb.shape[1]
        xs.append(emb)
    positions = torch.arange(S + n_prefix, device=tokens.device)[None]
    positions = positions.expand(B, S + n_prefix)
    tok_pos = positions[:, n_prefix:]
    xs.append(embed_tokens(params["embed"], tokens, cfg, tok_pos))
    x = torch.cat(xs, dim=1) if len(xs) > 1 else xs[0]
    return x, positions, n_prefix


# ----------------------------------------------------------------------
# Entry points
# ----------------------------------------------------------------------

def forward(params, batch, cfg: ModelConfig, cache=None, decode=False):
    _require_ported(cfg)
    if decode:
        length = _cache_length(cache, cfg)
        B = batch["tokens"].shape[0]
        positions = length.reshape(1, 1).expand(B, 1)
        x = embed_tokens(params["embed"], batch["tokens"], cfg, positions)
    else:
        x, positions, _ = embed_input(params, batch, cfg)
    if cfg.family == "ssm":
        state, counter = cache
        x, state = _stack_rwkv(params, x, state, cfg, decode)
        cache = (state, counter + x.shape[1])
    else:
        x, cache = _stack_dense(params, x, positions, cache, cfg, decode)
    if "final_norm" in params:
        x = apply_norm(params["final_norm"], x, cfg)
    logits = lm_logits(params["embed"], x, cfg)
    return logits, cache


def loss_fn(params, batch, cfg: ModelConfig):
    cache = empty_cache(params, batch, cfg, train=True)
    logits, _ = forward(params, batch, cfg, cache=cache)
    n_prefix = logits.shape[1] - batch["labels"].shape[1]
    if n_prefix:
        logits = logits[:, n_prefix:]
    return cross_entropy(logits, batch["labels"])


def prefill(params, batch, cfg: ModelConfig, max_len: int):
    cache = empty_cache(params, batch, cfg, train=False, max_len=max_len)
    logits, cache = forward(params, batch, cfg, cache=cache)
    return logits[:, -1:], cache


def decode_step(params, batch, cache, cfg: ModelConfig):
    logits, cache = forward(params, batch, cfg, cache=cache, decode=True)
    return logits, cache


# ----------------------------------------------------------------------
# Caches
# ----------------------------------------------------------------------

def _cache_length(cache, cfg: ModelConfig):
    _require_ported(cfg)
    if cfg.family == "ssm":
        return cache[1]  # rwkv: explicit token counter
    return cache["length"][0]


def empty_cache(params, batch, cfg: ModelConfig, *, train: bool,
                max_len: int = 0):
    """Zero cache on the batch's device.  Dense: a KV cache of ``max_len``
    positions, none for the full-sequence forward (``train``, no KV
    retention).  ssm: the zero recurrent state ((st, tm carry, cm carry),
    token counter), the same for both."""
    _require_ported(cfg)
    tokens = batch["tokens"]
    B, L, dev = tokens.shape[0], cfg.n_layers, tokens.device
    if cfg.family == "ssm":
        H, K = cfg.n_heads, cfg.d_model // cfg.n_heads
        st = torch.zeros((L, B, H, K, K), dtype=torch.float32, device=dev)
        carry = torch.zeros((L, B, 1, cfg.d_model), dtype=cfg.dtype,
                            device=dev)
        return ((st, carry, carry),
                torch.zeros((), dtype=torch.int32, device=dev))
    if train:
        return None
    return make_kv_cache(cfg, B, max_len, n_layers=L, dtype=cfg.dtype,
                         device=dev)
