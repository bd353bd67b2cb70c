"""Linear-recurrence blocks: the RWKV-6 (Finch) half of the JAX package's
``models/ssm.py``, on one chunked linear-attention core.

Recurrence (per head, state S in R^{K x V}):

    S_t = diag(w_t) . S_{t-1} + k_t v_t^T
    o_t = r_t . S_{t-1} + (r_t . (u * k_t)) v_t      (RWKV-6: pre-update + bonus)
    o_t = r_t . S_t                                   (Mamba-2: post-update)

``chunked_linear_attn`` processes T in blocks of ``chunk``: an inter-chunk
term against the carried state and an intra-chunk decay-weighted attention
matrix, a Python loop over the T/c chunks.  It is the plain version of the
``linear_scan`` kernel (``kernels/linear_scan/ref.py``).  ``rwkv6_time_mix``
reaches the chunked form through ``kernels.linear_scan.ops.scan_op``, which
launches the hand-written kernel on CUDA tensors; the JAX package's model
calls ``chunked_linear_attn`` directly and never takes its Pallas kernel.

Per-step log-decays are clamped at -60/chunk: contributions below e^-60
are exactly 0 in float32, and the clamp keeps the two-sided exp
factorisation inside float32 range.

The Mamba-2 half (``mamba2_specs``, ``_causal_conv``, ``mamba2_block``)
comes with the hybrid family (ROADMAP, queue 1 item 7).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from .layers import _einsum
from .param import ParamSpec

NEG_CLAMP = 60.0


def chunked_linear_attn(r, k, v, log_w, *, u=None, state0=None,
                        chunk: int = 64, post_update: bool = False):
    """r/k/log_w: (B, T, H, K); v: (B, T, H, V).  Returns (o, state_T) with
    o: (B, T, H, V) float32, state: (B, H, K, V) float32."""
    B, T, H, K = r.shape
    V = v.shape[-1]
    c = min(chunk, T)
    nc = T // c
    if nc * c != T:
        raise ValueError(f"T={T} not divisible by chunk={c}")
    r, k, v = r.float(), k.float(), v.float()
    lw = torch.clamp(log_w.float(), -NEG_CLAMP / c, 0.0)
    S = torch.zeros((B, H, K, V), dtype=torch.float32, device=r.device) \
        if state0 is None else state0
    idx = torch.arange(c, device=r.device)
    tri = idx[:, None] >= idx[None, :] if post_update else \
        idx[:, None] > idx[None, :]
    uf = None if u is None else u.float()
    outs = []
    for n in range(nc):
        sl = slice(n * c, (n + 1) * c)
        rb, kb, vb, lwb = r[:, sl], k[:, sl], v[:, sl], lw[:, sl]
        P = torch.cumsum(lwb, dim=1)             # inclusive cumulative decay
        Pq = P if post_update else P - lwb       # decay seen by the query
        q_eff = rb * torch.exp(Pq)
        k_eff = kb * torch.exp(-P)
        inter = torch.einsum("bchk,bhkv->bchv", q_eff, S)
        A = torch.einsum("bihk,bjhk->bhij", q_eff, k_eff) * tri
        if uf is not None:                       # RWKV-6 current-token bonus
            diag = torch.einsum("bchk,hk,bchk->bch", rb, uf, kb)
            A = A + torch.diag_embed(diag.transpose(1, 2))
        intra = torch.einsum("bhij,bjhv->bihv", A, vb)
        outs.append(inter + intra)
        S = S * torch.exp(P[:, -1])[..., None] + torch.einsum(
            "bchk,bchv->bhkv", kb * torch.exp(P[:, -1:] - P), vb)
    return torch.cat(outs, dim=1), S


def linear_attn_step(r, k, v, log_w, *, u=None, state=None,
                     post_update: bool = False):
    """Single-token decode step.  r/k/log_w: (B, H, K); v: (B, H, V);
    state: (B, H, K, V)."""
    r, k, v = r.float(), k.float(), v.float()
    w = torch.exp(torch.clamp(log_w.float(), -NEG_CLAMP, 0.0))
    kv = k[..., :, None] * v[..., None, :]       # (B, H, K, V)
    if post_update:
        state = state * w[..., None] + kv
        o = torch.einsum("bhk,bhkv->bhv", r, state)
    else:
        o = torch.einsum("bhk,bhkv->bhv", r, state)
        if u is not None:
            o = o + torch.einsum("bhk,bhkv->bhv", r * u.float()[None], kv)
        state = state * w[..., None] + kv
    return o, state


# ----------------------------------------------------------------------
# RWKV-6 block
# ----------------------------------------------------------------------

LORA = 32


def rwkv6_specs(cfg: ModelConfig, stacked: int) -> dict:
    d = cfg.d_model
    L, lx = (stacked,), ("layers",)

    def mat(shape, axes, **kw):
        return ParamSpec(L + shape, lx + axes, **kw)
    return {
        "mix": mat((5, d), (None, "embed"), init="zeros"),   # r,k,v,w,g lerp
        "wr": mat((d, d), ("embed", "heads_flat")),
        "wk": mat((d, d), ("embed", "heads_flat")),
        "wv": mat((d, d), ("embed", "heads_flat")),
        "wg": mat((d, d), ("embed", "heads_flat")),
        "wo": mat((d, d), ("heads_flat", "embed")),
        "w_base": mat((d,), ("embed",), init="zeros"),
        "w_lora_a": mat((d, LORA), ("embed", None), scale=0.01),
        "w_lora_b": mat((LORA, d), (None, "embed"), scale=0.01),
        "u": mat((d,), ("embed",), init="zeros"),
        "ln_x_scale": mat((d,), ("embed",), init="ones"),
        # channel mix (FFN)
        "cm_mix": mat((2, d), (None, "embed"), init="zeros"),
        "cm_k": mat((d, cfg.d_ff), ("embed", "mlp")),
        "cm_v": mat((cfg.d_ff, d), ("mlp", "embed")),
        "cm_r": mat((d, d), ("embed", "embed_out")),
    }


def _mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w`` for a (B, T, D) activation, with ``jnp``'s dtype
    promotion."""
    return _einsum("btd,de->bte", a, w)


def _token_shift(x, prev):
    """prev: (B, 1, D) last token of the previous segment (zeros at start).
    Returns x_{t-1} aligned with x_t, and the new carry."""
    return torch.cat([prev, x[:, :-1]], dim=1), x[:, -1:]


def _lerp(x, x_prev, mu):
    return x + (x_prev - x) * mu.to(x.dtype)


def rwkv6_time_mix(p, x, x_prev, cfg: ModelConfig, *, state=None,
                   decode=False):
    """Returns (y, (new_state, new_x_carry))."""
    from ..kernels.linear_scan.ops import scan_op  # kernels import models
    B = x.shape[0]
    d = cfg.d_model
    H, K = cfg.n_heads, d // cfg.n_heads
    if decode:
        xs, carry = x_prev, x  # (B, 1, D) carry
    else:
        xs, carry = _token_shift(x, x_prev)
    mix = p["mix"].float()
    xr = _lerp(x, xs, mix[0])
    xk = _lerp(x, xs, mix[1])
    xv = _lerp(x, xs, mix[2])
    xw = _lerp(x, xs, mix[3])
    xg = _lerp(x, xs, mix[4])
    r = _mm(xr, p["wr"]).reshape(B, -1, H, K)
    k = _mm(xk, p["wk"]).reshape(B, -1, H, K)
    v = _mm(xv, p["wv"]).reshape(B, -1, H, K)
    g = _mm(xg, p["wg"])
    ww = p["w_base"].float() + (xw.float() @ p["w_lora_a"].float()
                                ) @ p["w_lora_b"].float()
    log_w = -torch.exp(ww.reshape(B, -1, H, K))  # data-dependent decay < 0
    u = p["u"].float().reshape(H, K)

    if decode:
        o, new_state = linear_attn_step(
            r[:, 0], k[:, 0], v[:, 0], log_w[:, 0], u=u, state=state)
        o = o[:, None]
    else:
        # float32 r, k, v, as chunked_linear_attn casts them: the kernel
        # returns o in r's dtype, and the reference keeps o in float32
        o, new_state = scan_op(r.float(), k.float(), v.float(), log_w, u=u,
                               state0=state, chunk=cfg.chunk_size)
    # per-head group norm
    of = o.reshape(B, -1, H, K).float()
    of = of * torch.rsqrt(torch.mean(of * of, -1, keepdim=True) + 1e-6)
    of = of.reshape(B, -1, d) * p["ln_x_scale"].float()
    y = _mm((of * F.silu(g.float())).to(x.dtype), p["wo"])
    return y, (new_state, carry)


def rwkv6_channel_mix(p, x, x_prev, cfg: ModelConfig, decode=False):
    if decode:
        xs, carry = x_prev, x
    else:
        xs, carry = _token_shift(x, x_prev)
    mix = p["cm_mix"].float()
    xk = _lerp(x, xs, mix[0])
    xr = _lerp(x, xs, mix[1])
    h = torch.clamp_min(_mm(xk, p["cm_k"]), 0.0) ** 2
    y = _mm(h, p["cm_v"]) * torch.sigmoid(
        _mm(xr, p["cm_r"]).float()).to(x.dtype)
    return y, carry
