"""Plain PyTorch versions of the flash attention kernels: dense softmax
attention, op for op as the JAX package's ``attention_ref``, and its
gradient written out as formulas.  Both compute in float32 (float64
inputs stay float64, for gradient checks)."""
from __future__ import annotations

import torch


def _wide(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.promote_types(t.dtype, torch.float32))


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
    s = torch.einsum("bqhd,bkhd->bhqk", _wide(q), _wide(k)) * (D ** -0.5)
    if causal:
        pos_k = torch.arange(Sk, device=q.device)
        pos_q = torch.arange(Sq, device=q.device)
        mask = pos_k[None, :] <= pos_q[:, None]
        s = torch.where(mask[None, None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, _wide(v))
    return o.to(q.dtype)


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      o: torch.Tensor, do: torch.Tensor, *,
                      causal: bool = True):
    """The gradient of ``attention_ref`` written out as formulas, in
    float32: the row log-sum-exp ``lse`` of the scaled, masked scores,
    P = exp(s - lse), delta = rowsum(do * o), dP = do . v^T,
    dS = P * (dP - delta), then dq = scale dS . k, dk = scale dS^T . q and
    dv = P^T . do, the query heads of a group summed into their KV head.
    ``o`` is the forward's output.  Returns (dq, dk, dv) in the dtypes of
    q, k and v."""
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    g = Hq // Hkv
    scale = D ** -0.5
    qf, kf, vf = _wide(q), _wide(k), _wide(v)
    if g > 1:
        kf = torch.repeat_interleave(kf, g, dim=2)
        vf = torch.repeat_interleave(vf, g, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    if causal:
        pos_k = torch.arange(Sk, device=q.device)
        pos_q = torch.arange(Sq, device=q.device)
        mask = pos_k[None, :] <= pos_q[:, None]
        s = torch.where(mask[None, None], s, -1e30)
    lse = torch.logsumexp(s, dim=-1, keepdim=True)
    p = torch.exp(s - lse)
    del s
    dof = _wide(do)
    delta = torch.sum(dof * _wide(o), dim=-1)            # (B, Sq, Hq)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - delta.transpose(1, 2)[..., None])
    del p, dp
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    if g > 1:
        dk = dk.reshape(B, Sk, Hkv, g, D).sum(3)
        dv = dv.reshape(B, Sk, Hkv, g, D).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
