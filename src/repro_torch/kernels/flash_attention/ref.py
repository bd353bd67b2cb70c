"""Plain PyTorch versions of the flash attention kernels: dense softmax
attention, op for op as the JAX package's ``attention_ref`` (optionally
with its rows' log-sum-exp, which the forward kernels write for the
backward), and its gradient written out as formulas.  All compute in
float32 (float64 inputs stay float64, for gradient checks)."""
from __future__ import annotations

import torch


def _wide(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool) -> torch.Tensor:
    """scale q.k^T, (B, Hq, Sq, Sk), K repeated to Hq heads, masked
    ``k_pos <= q_pos`` with -1e30."""
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    g = Hq // Hkv
    kf = _wide(k)
    if g > 1:
        kf = torch.repeat_interleave(kf, g, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", _wide(q), kf) * (D ** -0.5)
    if causal:
        pos_k = torch.arange(Sk, device=q.device)
        pos_q = torch.arange(Sq, device=q.device)
        mask = pos_k[None, :] <= pos_q[:, None]
        s = torch.where(mask[None, None], s, -1e30)
    return s


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, return_lse: bool = False):
    """Dense softmax attention; q (B,Sq,Hq,D), k/v (B,Sk,Hkv,D).  K/V are
    repeated to Hq heads, scores are float32, masked ``k_pos <= q_pos`` with
    -1e30; the result is in q's dtype.  With ``return_lse`` -> (o, lse),
    lse the natural-log row log-sum-exp of the scaled, masked scores,
    (B, Hq, Sq) in float32 (what the forward kernels write)."""
    Hq, Hkv = q.shape[2], k.shape[2]
    s = _scores(q, k, causal)
    p = torch.softmax(s, dim=-1)
    vf = _wide(v)
    if Hq // Hkv > 1:
        vf = torch.repeat_interleave(vf, Hq // Hkv, dim=2)
    o = torch.einsum("bhqk,bkhd->bqhd", p, vf).to(q.dtype)
    if return_lse:
        return o, torch.logsumexp(s, dim=-1)
    return o


def attention_delta_ref(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(do * o) in float32, (B, Hq, Sq): the backward's first
    pass."""
    return torch.sum(_wide(do) * _wide(o), dim=-1).transpose(1, 2)


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      o: torch.Tensor, do: torch.Tensor, *,
                      causal: bool = True, lse: torch.Tensor | None = None):
    """The gradient of ``attention_ref`` written out as formulas, in
    float32: the row log-sum-exp ``lse`` of the scaled, masked scores
    (computed here unless given, (B, Hq, Sq), as the forward kernels write
    it), P = exp(s - lse), delta = rowsum(do * o), dP = do . v^T,
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
    s = _scores(q, k, causal)
    if lse is None:
        lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse.to(s.dtype)[..., None])
    del s
    dof = _wide(do)
    delta = attention_delta_ref(o, do)                   # (B, Hq, Sq)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - delta[..., None])
    del p, dp
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    if g > 1:
        dk = dk.reshape(B, Sk, Hkv, g, D).sum(3)
        dv = dv.reshape(B, Sk, Hkv, g, D).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
