"""Decoder-LM assembly for the dense, moe, ssm (RWKV-6) and hybrid (Zamba2)
families (the encoder-decoder one is ``encdec``).

One spec builder and three entry points:

  * ``loss_fn(params, batch, cfg)``            -- the evaluation objective
  * ``prefill(params, batch, cfg, max_len)``   -- build decode caches
  * ``decode_step(params, batch, cache, cfg)`` -- one token for the batch

Layer weights are stacked on a leading ``L`` axis, as in the JAX package;
each layer stack is a Python loop over the layers (``torch.unbind`` of
the stacks, whose gradient is one stack of the per-layer gradients) that
stacks the new per-layer caches (KV caches, or recurrent states) back to
``(L, ...)``.  Under grad, outside decode, each block is rematerialised as
``cfg.remat`` says (``_maybe_remat``).

The hybrid family interleaves the Mamba-2 layers with one *shared*
attention block applied every ``cfg.attn_every`` layers: the shared
block's weights are the same at every application, its KV cache is
indexed by application number.  The moe family is the dense stack with
a mixture of experts (``moe.apply_moe``) in place of each layer's MLP.
"""
from __future__ import annotations

import torch
from torch.utils import checkpoint as ckpt

from ..configs.base import ModelConfig
from . import ssm
from .layers import (apply_mlp, apply_norm, attention, attention_specs,
                     cross_entropy, embed_specs, embed_tokens, lm_logits,
                     make_kv_cache, mlp_specs, norm_specs)
from .moe import apply_moe, moe_specs
from .param import ParamSpec, SpecTree


# ----------------------------------------------------------------------
# Spec builders
# ----------------------------------------------------------------------

def frontend_specs(cfg: ModelConfig) -> dict:
    if not cfg.frontend:
        return {}
    return {"proj": ParamSpec((cfg.frontend_dim, cfg.d_model),
                              (None, "embed"))}


def lm_specs(cfg: ModelConfig) -> SpecTree:
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
    elif cfg.family == "hybrid":
        block = dict(ssm.mamba2_specs(cfg, L))
        block["norm"] = norm_specs(cfg, L)
    elif cfg.family in ("dense", "moe"):
        block = {"attn": attention_specs(cfg, L)}
        an = norm_specs(cfg, L)
        if an:
            block["attn_norm"] = an
            block["mlp_norm"] = norm_specs(cfg, L)
        block["mlp"] = moe_specs(cfg, L) if cfg.family == "moe" \
            else mlp_specs(cfg, L)
    else:
        raise ValueError(cfg.family)  # encdec: encdec.encdec_specs
    specs["blocks"] = block
    if cfg.family == "hybrid":
        specs["shared"] = {"attn": attention_specs(cfg),
                           "attn_norm": norm_specs(cfg),
                           "mlp_norm": norm_specs(cfg),
                           "mlp": mlp_specs(cfg)}
    return specs


def n_attn_apps(cfg: ModelConfig) -> int:
    return cfg.n_layers // cfg.attn_every if cfg.attn_every else 0


# ----------------------------------------------------------------------
# Blocks and the stack
# ----------------------------------------------------------------------

def _dense_block(pl, x, positions, cache_l, cfg: ModelConfig, decode: bool):
    h = apply_norm(pl.get("attn_norm", {}), x, cfg)
    a, new_cache = attention(pl["attn"], h, cfg, positions=positions,
                             cache=cache_l, decode=decode)
    x = x + a
    h = apply_norm(pl.get("mlp_norm", {}), x, cfg)
    m = apply_moe(pl["mlp"], h, cfg) if cfg.family == "moe" \
        else apply_mlp(pl["mlp"], h, cfg)
    return x + m, new_cache


def _rwkv_block(pl, x, state_l, cfg: ModelConfig, decode: bool):
    st, tm_carry, cm_carry = state_l
    h = apply_norm(pl["tm_norm"], x, cfg)
    y, (st2, tm2) = ssm.rwkv6_time_mix(pl, h, tm_carry, cfg, state=st,
                                       decode=decode)
    x = x + y
    h = apply_norm(pl["cm_norm"], x, cfg)
    y, cm2 = ssm.rwkv6_channel_mix(pl, h, cm_carry, cfg, decode=decode)
    return x + y, (st2, tm2, cm2)


def _mamba_block(pl, x, state_l, cfg: ModelConfig, decode: bool):
    st, conv = state_l
    h = apply_norm(pl["norm"], x, cfg)
    y, (st2, conv2) = ssm.mamba2_block(pl, h, cfg, state=st,
                                       conv_state=conv, decode=decode)
    return x + y, (st2, conv2)


def _shared_attn_block(ps, x, positions, cache_app, cfg: ModelConfig,
                       decode: bool):
    h = apply_norm(ps["attn_norm"], x, cfg)
    a, new_cache = attention(ps["attn"], h, cfg, positions=positions,
                             cache=cache_app, decode=decode)
    x = x + a
    h = apply_norm(ps["mlp_norm"], x, cfg)
    return x + apply_mlp(ps["mlp"], h, cfg), new_cache


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


def _hybrid_group(layers, shared, x, positions, states, cache_g,
                  cfg: ModelConfig, decode: bool):
    """``attn_every`` Mamba-2 layers, then one application of the shared
    block on its own KV cache (None for the full-sequence forward) ->
    (x, the layers' new states, the new cache)."""
    new = []
    for pl, state_l in zip(layers, states):
        x, state_l = _mamba_block(pl, x, state_l, cfg, decode)
        new.append(state_l)
    x, cache_g = _shared_attn_block(shared, x, positions, cache_g, cfg,
                                    decode)
    return x, new, cache_g


def _stack_hybrid(params, x, positions, state, cfg: ModelConfig,
                  decode: bool):
    """``state`` is ((st (L,B,H,N,P), conv (L,B,W-1,C)), attention cache
    of ``n_attn_apps`` entries or None).  G groups of ``attn_every`` Mamba-2
    layers and one shared-block application each, then the tail of the
    leftover layers; each group and each tail layer is rematerialised as
    the JAX package's scans are.  Returns x and the new state, the Mamba-2
    states stacked back to (L, ...) in layer order."""
    every, G = cfg.attn_every, n_attn_apps(cfg)
    (st, conv), attn_cache = state
    n_layers = st.shape[0]
    layers = _unstack(params["blocks"], n_layers)
    states = list(zip(torch.unbind(st), torch.unbind(conv)))
    caches = [None] * G if attn_cache is None else _unstack(attn_cache, G)
    group = _maybe_remat(_hybrid_group, cfg, decode)
    new, new_caches = [], []
    for g in range(G):
        sl = slice(g * every, (g + 1) * every)
        x, new_g, cache_g = group(layers[sl], params["shared"], x, positions,
                                  states[sl], caches[g], cfg, decode)
        new += new_g
        new_caches.append(cache_g)
    block = _maybe_remat(_mamba_block, cfg, decode)
    for pl, state_l in zip(layers[G * every:], states[G * every:]):
        x, state_l = block(pl, x, state_l, cfg, decode)
        new.append(state_l)
    mamba = tuple(torch.stack(s) for s in zip(*new))
    if attn_cache is None:
        return x, (mamba, None)
    return x, (mamba, {k: torch.stack([c[k] for c in new_caches])
                       for k in new_caches[0]})


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
    elif cfg.family == "hybrid":
        x, cache = _stack_hybrid(params, x, positions, cache, cfg, decode)
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
    if cfg.family == "ssm":
        return cache[1]  # rwkv: explicit token counter
    if cfg.family == "hybrid":
        return cache[1]["length"][0]
    return cache["length"][0]


def empty_cache(params, batch, cfg: ModelConfig, *, train: bool,
                max_len: int = 0):
    """Zero cache on the batch's device.  Dense and moe: a KV cache of
    ``max_len`` positions, none for the full-sequence forward (``train``,
    no KV retention).  ssm: the zero recurrent state ((st, tm carry, cm
    carry), token counter), the same for both.  hybrid: ((the float32 Mamba-2
    state, the conv state), the shared block's KV cache of one entry an
    application, None for ``train``)."""
    tokens = batch["tokens"]
    B, L, dev = tokens.shape[0], cfg.n_layers, tokens.device
    if cfg.family == "ssm":
        H, K = cfg.n_heads, cfg.d_model // cfg.n_heads
        st = torch.zeros((L, B, H, K, K), dtype=torch.float32, device=dev)
        carry = torch.zeros((L, B, 1, cfg.d_model), dtype=cfg.dtype,
                            device=dev)
        return ((st, carry, carry),
                torch.zeros((), dtype=torch.int32, device=dev))
    if cfg.family == "hybrid":
        H, N = cfg.ssm_heads, cfg.ssm_state
        di = cfg.d_model * cfg.ssm_expand
        st = torch.zeros((L, B, H, N, di // H), dtype=torch.float32,
                         device=dev)
        conv = torch.zeros((L, B, cfg.conv_width - 1, di + 2 * N),
                           dtype=cfg.dtype, device=dev)
        if train:
            return ((st, conv), None)
        return ((st, conv), make_kv_cache(
            cfg, B, max(max_len, 1), n_layers=max(1, n_attn_apps(cfg)),
            dtype=cfg.dtype, device=dev))
    if train:
        return None
    return make_kv_cache(cfg, B, max_len, n_layers=L, dtype=cfg.dtype,
                         device=dev)
