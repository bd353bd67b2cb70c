"""Mixture-of-Experts layer: top-k routing with per-row capacity, scatter/
gather dispatch over an ``E * cap + 1`` slot buffer (no dense (T, E, C)
one-hots), stacked expert weights; the JAX package's ``models/moe.py``.

The expert products are batched matrix products over the stacked
weights; the JAX package computes them outside any Pallas kernel, and so
does the port.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from .layers import _einsum
from .param import ParamSpec


def moe_specs(cfg: ModelConfig, stacked: int | None = None) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    lead = (stacked,) if stacked else ()
    lax_ = ("layers",) if stacked else ()
    out = {
        "router": ParamSpec(lead + (d, e), lax_ + ("embed", None),
                            scale=d ** -0.5),
        "w_up": ParamSpec(lead + (e, d, f),
                          lax_ + ("experts", "embed", "mlp")),
        "w_gate": ParamSpec(lead + (e, d, f),
                            lax_ + ("experts", "embed", "mlp")),
        "w_down": ParamSpec(lead + (e, f, d),
                            lax_ + ("experts", "mlp", "embed")),
    }
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        out["shared_up"] = ParamSpec(lead + (d, fs), lax_ + ("embed", "mlp"))
        out["shared_gate"] = ParamSpec(lead + (d, fs), lax_ + ("embed", "mlp"))
        out["shared_down"] = ParamSpec(lead + (fs, d), lax_ + ("mlp", "embed"))
    return out


def _expert_ffn(params, xe: torch.Tensor) -> torch.Tensor:
    """xe: (B, E, C, D) -> (B, E, C, D), experts along axis 1."""
    up = _einsum("becd,edf->becf", xe, params["w_up"])
    gate = _einsum("becd,edf->becf", xe, params["w_gate"])
    h = F.silu(gate.float()) * up.float()
    return _einsum("becf,efd->becd", h.to(xe.dtype), params["w_down"])


def route(logits: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(gates, idx), each (..., k): the k largest softmax probabilities of
    ``logits`` (float32) and their experts, ties to the lower index, as
    ``jax.lax.top_k``: a stable descending sort (``torch.topk`` promises
    no order among equal values, and bf16 logits tie often)."""
    probs = torch.softmax(logits.float(), dim=-1)
    gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return gates[..., :k], idx[..., :k]


def apply_moe(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x: (B, S, D).  Per-row (per-batch-element) capacity: each row's
    (token, slot) pairs take an expert's places in (token, slot) order,
    and those past ``cap`` are dropped (their weight 0)."""
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    cap = max(1, int(S * k / E * cfg.capacity_factor))

    logits = _einsum("bsd,de->bse", x, params["router"].to(x.dtype))
    gates, idx = route(logits, k)                    # (B, S, k)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)

    # position of each (token, slot) within its expert, per batch row: a
    # running count along T' of the expert-major one-hot (B, E, T'), a
    # scan along the innermost dim (the token-major (B, T', E) one-hot
    # scanned along dim 1 took 2.4 ms a moonshot-v1-16b-a3b layer on an
    # H100)
    flat_e = idx.reshape(B, S * k)                   # (B, T')
    onehot = F.one_hot(flat_e, E).transpose(1, 2).contiguous()
    pos = torch.cumsum(onehot, dim=2, dtype=torch.int32) - 1
    pos = torch.gather(pos, 1, flat_e[:, None, :])[:, 0]
    keep = pos < cap
    # scatter target: index into (E*cap + 1) slots, overflow -> sentinel
    slot = torch.where(keep, flat_e * cap + pos, E * cap)    # (B, T')

    # one scatter of all (token, slot) pairs into the row's slot buffer.
    # The kept slots are unique, so each is one add into zero, exact and
    # the same on every call; index_add_ into the sentinel row E*cap sums
    # the dropped pairs in no fixed order on CUDA, and that row is thrown
    # away
    n = E * cap + 1
    x_slots = torch.repeat_interleave(x, k, dim=1)   # (B, S*k, D)
    rows = slot + n * torch.arange(B, device=x.device)[:, None]
    buf = torch.zeros((B * n, D), dtype=x.dtype, device=x.device)
    buf.index_add_(0, rows.reshape(-1), x_slots.reshape(B * S * k, D))
    xe = buf.reshape(B, n, D)[:, :E * cap].reshape(B, E, cap, D)

    ye = _expert_ffn(params, xe)                     # (B, E, cap, D)
    ye_flat = torch.cat([ye.reshape(B, E * cap, D),
                         ye.new_zeros((B, 1, D))], dim=1)
    y_slots = torch.gather(ye_flat, 1, slot[..., None].expand(B, S * k, D))
    w = (gates * keep.reshape(B, S, k)).float()
    y = torch.sum(y_slots.float().reshape(B, S, k, D) * w[..., None], dim=2)

    if cfg.n_shared_experts:
        up = _einsum("bsd,df->bsf", x, params["shared_up"])
        gate = _einsum("bsd,df->bsf", x, params["shared_gate"])
        h = F.silu(gate.float()) * up.float()
        y = y + _einsum("bsf,fd->bsd", h.to(x.dtype),
                        params["shared_down"]).float()
    return y.to(x.dtype)


def aux_load_balance_loss(logits: torch.Tensor, idx: torch.Tensor,
                          n_experts: int) -> torch.Tensor:
    """Switch-style load-balance auxiliary loss (for a trainer to weight;
    the JAX package's train path does not add it)."""
    probs = torch.softmax(logits.float(), -1)
    me = torch.mean(probs.reshape(-1, n_experts), dim=0)
    ce = torch.mean(F.one_hot(idx[..., 0].reshape(-1).long(),
                              n_experts).float(), dim=0)
    return n_experts * torch.sum(me * ce)
