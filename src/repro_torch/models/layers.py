"""Transformer building blocks: norms, RoPE, GQA attention (chunked online
softmax for the full sequence, cache-based for decode), MLPs.

Everything is functional, ``f(params, x, cfg, ...) -> y``, over parameter
dicts with the JAX package's names and layouts.  The full-sequence
attention with no cache takes the hand-written flash attention kernel when
its inputs lie on the card; every other case runs the plain paths below,
as the JAX package does off the TPU.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels.flash_attention import flash_attention
from .param import ParamSpec

NEG_INF = -1e30


def _einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.einsum`` with its dtype promotion (torch's einsum needs one
    dtype): bf16 with float32 computes in float32."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(dt), b.to(dt))


# ----------------------------------------------------------------------
# Norms
# ----------------------------------------------------------------------

def norm_specs(cfg: ModelConfig, stacked: int | None = None) -> dict:
    lead = (stacked,) if stacked else ()
    lax_ = ("layers",) if stacked else ()
    if cfg.norm == "ln_nonparam":
        return {}
    out = {"scale": ParamSpec(lead + (cfg.d_model,), lax_ + ("embed",),
                              init="ones")}
    if cfg.norm == "ln":
        out["bias"] = ParamSpec(lead + (cfg.d_model,), lax_ + ("embed",),
                                init="zeros")
    return out


def apply_norm(params: dict, x: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    xf = x.float()
    if cfg.norm == "rms":
        y = xf * torch.rsqrt(torch.mean(xf * xf, -1, keepdim=True) + 1e-6)
        return (y * params["scale"].float()).to(x.dtype)
    mu = torch.mean(xf, -1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, -1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + 1e-5)
    if cfg.norm == "ln":
        y = y * params["scale"].float() + params["bias"].float()
    return y.to(x.dtype)


# ----------------------------------------------------------------------
# RoPE
# ----------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float,
               device: torch.device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                 # (D/2,)
    ang = positions[..., None].float() * freqs             # (B, S, D/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


# ----------------------------------------------------------------------
# Attention
# ----------------------------------------------------------------------

def attention_specs(cfg: ModelConfig, stacked: int | None = None,
                    d_kv_src: int | None = None) -> dict:
    """QKV/out projection specs.  ``d_kv_src`` overrides the K/V source
    width (cross-attention)."""
    d, hd = cfg.d_model, cfg.head_dim_
    dkv = d_kv_src or d
    lead = (stacked,) if stacked else ()
    lax_ = ("layers",) if stacked else ()
    # explicit fan-in scales: the (d, H, hd) layout defeats the last-but-
    # one-dim heuristic (it would read H as the fan-in)
    out = {
        "wq": ParamSpec(lead + (d, cfg.n_heads, hd),
                        lax_ + ("embed", "heads", "qkv"),
                        scale=d ** -0.5),
        "wk": ParamSpec(lead + (dkv, cfg.n_kv_heads, hd),
                        lax_ + ("embed", "kv_heads", "qkv"),
                        scale=dkv ** -0.5),
        "wv": ParamSpec(lead + (dkv, cfg.n_kv_heads, hd),
                        lax_ + ("embed", "kv_heads", "qkv"),
                        scale=dkv ** -0.5),
        "wo": ParamSpec(lead + (cfg.n_heads, hd, d),
                        lax_ + ("heads", "qkv", "embed"),
                        scale=(cfg.n_heads * hd) ** -0.5),
    }
    if cfg.qkv_bias:
        out["bq"] = ParamSpec(lead + (cfg.n_heads, hd),
                              lax_ + ("heads", "qkv"), init="zeros")
        out["bk"] = ParamSpec(lead + (cfg.n_kv_heads, hd),
                              lax_ + ("kv_heads", "qkv"), init="zeros")
        out["bv"] = ParamSpec(lead + (cfg.n_kv_heads, hd),
                              lax_ + ("kv_heads", "qkv"), init="zeros")
    return out


def _project_qkv(params, xq, xkv, cfg: ModelConfig):
    q = _einsum("bsd,dhk->bshk", xq, params["wq"])
    k = _einsum("bsd,dhk->bshk", xkv, params["wk"])
    v = _einsum("bsd,dhk->bshk", xkv, params["wv"])
    if cfg.qkv_bias:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    return q, k, v


def _gqa_scores_full(q, k, v, causal: bool, q_offset: int, chunk: int):
    """Chunked online-softmax attention (flash-style, plain PyTorch).

    q: (B, Sq, Hq, D), k/v: (B, Sk, Hkv, D).  Loops over query blocks so
    peak memory is O(Sq_block x Sk) instead of O(Sq x Sk).  K/V are repeated
    up to Hq heads, as in the JAX package."""
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    g = Hq // Hkv
    scale = D ** -0.5
    if g > 1:
        k = torch.repeat_interleave(k, g, dim=2)
        v = torch.repeat_interleave(v, g, dim=2)
    # largest block count <= Sq/chunk that divides Sq (frontends can make
    # Sq a non-multiple of the chunk, e.g. 576 patches + 4096 tokens)
    nblk = max(1, Sq // chunk)
    while Sq % nblk:
        nblk -= 1
    blk = Sq // nblk
    kT = k.float()
    vT = v.float()
    kv_pos = torch.arange(Sk, device=q.device)
    outs = []
    for idx in range(nblk):
        qblk = q[:, idx * blk:(idx + 1) * blk]
        s = torch.einsum("bqhd,bkhd->bhqk", qblk.float(), kT) * scale
        if causal:
            qpos = q_offset + idx * blk + torch.arange(blk, device=q.device)
            mask = kv_pos[None, :] <= qpos[:, None]          # (blk, Sk)
            s = torch.where(mask[None, None], s, NEG_INF)
        m = torch.amax(s, -1, keepdim=True)
        p = torch.exp(s - m)
        l = torch.sum(p, -1, keepdim=True)
        outs.append(torch.einsum("bhqk,bkhd->bqhd",
                                 p / torch.clamp(l, min=1e-30), vT))
    return torch.cat(outs, dim=1).to(q.dtype)


def _gqa_decode(q, k_cache, v_cache, length):
    """One-step decode: q (B, 1, Hq, D) vs cache (B, Smax, Hkv, D); only
    the first ``length`` cache entries are valid.  Products are exact and
    sums float32, as the JAX package's ``preferred_element_type``; the
    query heads of one KV head are grouped instead of repeating the cache
    (the same products and sums, without the copy)."""
    B, _, Hq, D = q.shape
    _, Sk, Hkv, _ = k_cache.shape
    g = Hq // Hkv
    qb = q.reshape(B, Hkv, g, D).to(k_cache.dtype).float()
    s = torch.einsum("bngd,bknd->bngk", qb, k_cache.float()) * (D ** -0.5)
    mask = torch.arange(Sk, device=q.device)[None, None, None, :] < length
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bngk,bknd->bngd", p, v_cache.float())
    return o.reshape(B, 1, Hq, D).to(q.dtype)


def attention(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
              positions: torch.Tensor, causal: bool = True,
              xkv: torch.Tensor | None = None,
              cache: dict | None = None,
              decode: bool = False) -> tuple[torch.Tensor, dict | None]:
    """Returns (output, new_cache).  Modes:

    * full sequence (``decode=False``): with no cache, the flash attention
      kernel when q lies on the card and both lengths are multiples of 128,
      else chunked attention; if ``cache`` is given it is filled (prefill,
      always the chunked path, as in the JAX package).
    * decode: ``x`` is (B, 1, D); reads/updates ``cache`` at
      ``cache['length']``.
    * cross-attention: pass ``xkv`` (encoder output) and ``causal=False``.
    """
    src = xkv if xkv is not None else x
    q, k, v = _project_qkv(params, x, src, cfg)
    if cfg.pos == "rope" and xkv is None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    if q.is_cuda and not decode and cache is None and \
            q.shape[1] % 128 == 0 and k.shape[1] % 128 == 0:
        out = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                              causal=causal and xkv is None)
        return _einsum("bshk,hkd->bsd", out, params["wo"]), None

    new_cache = None
    if decode:
        if cache is None:
            raise ValueError("attention: decode needs a cache")
        length = cache["length"]
        # the new entry goes in at ``length``, as the JAX package's one-hot
        # select does (a length past the cache drops the write)
        sel = (torch.arange(cache["k"].shape[1], device=x.device)
               == length)[None, :, None, None]
        k_cache = torch.where(sel, k.to(cache["k"].dtype), cache["k"])
        v_cache = torch.where(sel, v.to(cache["v"].dtype), cache["v"])
        out = _gqa_decode(q, k_cache, v_cache, length + 1)
        new_cache = {"k": k_cache, "v": v_cache, "length": length + 1}
    else:
        out = _gqa_scores_full(q, k, v, causal and xkv is None,
                               q_offset=0, chunk=cfg.chunk_size)
        if cache is not None:
            pad = cache["k"].shape[1] - k.shape[1]
            new_cache = {
                "k": F.pad(k.to(cache["k"].dtype), (0, 0, 0, 0, 0, pad)),
                "v": F.pad(v.to(cache["v"].dtype), (0, 0, 0, 0, 0, pad)),
                "length": torch.tensor(k.shape[1], dtype=torch.int32,
                                       device=x.device),
            }
    y = _einsum("bshk,hkd->bsd", out, params["wo"])
    return y, new_cache


def make_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                  n_layers: int | None = None, dtype=torch.bfloat16, *,
                  device: torch.device) -> dict:
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim_)
    if n_layers is not None:
        shape = (n_layers,) + shape
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "length": torch.zeros((n_layers,) if n_layers is not None else (),
                              dtype=torch.int32, device=device),
    }


# ----------------------------------------------------------------------
# MLP
# ----------------------------------------------------------------------

def mlp_specs(cfg: ModelConfig, stacked: int | None = None,
              d_ff: int | None = None) -> dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    lead = (stacked,) if stacked else ()
    lax_ = ("layers",) if stacked else ()
    out = {
        "w_up": ParamSpec(lead + (d, f), lax_ + ("embed", "mlp")),
        "w_down": ParamSpec(lead + (f, d), lax_ + ("mlp", "embed")),
    }
    if cfg.mlp_type == "swiglu":
        out["w_gate"] = ParamSpec(lead + (d, f), lax_ + ("embed", "mlp"))
    return out


def apply_mlp(params: dict, x: torch.Tensor,
              cfg: ModelConfig) -> torch.Tensor:
    up = _einsum("bsd,df->bsf", x, params["w_up"])
    if cfg.mlp_type == "swiglu":
        gate = _einsum("bsd,df->bsf", x, params["w_gate"])
        h = F.silu(gate.float()) * up.float()
    else:
        h = F.gelu(up.float(), approximate="tanh")  # jax.nn.gelu's default
    return _einsum("bsf,fd->bsd", h.to(x.dtype), params["w_down"])


# ----------------------------------------------------------------------
# Embeddings / head
# ----------------------------------------------------------------------

def embed_specs(cfg: ModelConfig) -> dict:
    v = cfg.padded_vocab
    out = {"tok": ParamSpec((v, cfg.d_model), ("vocab", "embed"),
                            init="embed", scale=1.0)}
    if cfg.pos == "learned":
        out["pos"] = ParamSpec((cfg.max_learned_pos, cfg.d_model),
                               (None, "embed"), init="embed", scale=0.02)
    if not cfg.tie_embeddings:
        out["head"] = ParamSpec((cfg.d_model, v), ("embed", "vocab"))
    return out


def embed_tokens(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor) -> torch.Tensor:
    x = params["tok"][tokens]
    if cfg.pos == "learned":
        x = x + params["pos"][positions % cfg.max_learned_pos]
    return x.to(cfg.dtype)


def lm_logits(params: dict, x: torch.Tensor,
              cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        out = _einsum("bsd,vd->bsv", x, params["tok"].to(x.dtype))
    else:
        out = _einsum("bsd,dv->bsv", x, params["head"])
    if cfg.padded_vocab != cfg.vocab:
        pad_mask = torch.arange(cfg.padded_vocab, device=x.device) < cfg.vocab
        out = torch.where(pad_mask, out, NEG_INF)
    return out


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  z_loss: float = 1e-4) -> torch.Tensor:
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.gather(lf, -1, labels[..., None].long())[..., 0]
    loss = lse - ll
    if z_loss:
        loss = loss + z_loss * lse ** 2
    return torch.mean(loss)
