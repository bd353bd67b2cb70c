"""Plain PyTorch version of the flash attention kernel: dense softmax
attention, op for op as the JAX package's ``attention_ref``."""
from __future__ import annotations

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True) -> torch.Tensor:
    """Dense softmax attention; q (B,Sq,Hq,D), k/v (B,Sk,Hkv,D).  K/V are
    repeated to Hq heads, scores are float32, masked ``k_pos <= q_pos`` with
    -1e30; the result is in q's dtype."""
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    g = Hq // Hkv
    if g > 1:
        k = torch.repeat_interleave(k, g, dim=2)
        v = torch.repeat_interleave(v, g, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (D ** -0.5)
    if causal:
        pos_k = torch.arange(Sk, device=q.device)
        pos_q = torch.arange(Sq, device=q.device)
        mask = pos_k[None, :] <= pos_q[:, None]
        s = torch.where(mask[None, None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return o.to(q.dtype)
