"""Plain PyTorch versions of the linear-scan kernels: the model layer's
chunked implementation (``models/ssm.py``), as in the JAX package, and its
gradient written out chunk by chunk."""
from __future__ import annotations

import numpy as np
import torch

from ...models.ssm import chunked_linear_attn


def linear_scan_ref(r, k, v, log_w, u=None, state0=None, *, chunk=64,
                    post_update=False):
    """Returns (o (B,T,H,V) float32, state (B,H,K,V) float32)."""
    return chunked_linear_attn(r, k, v, log_w, u=u, state0=state0,
                               chunk=chunk, post_update=post_update)


def linear_scan_bwd_ref(r, k, v, log_w, u=None, state0=None, do=None,
                        dstate=None, *, chunk=64, post_update=False):
    """The vector-Jacobian product of ``linear_scan_ref`` with respect to
    r, k, v, log_w, u and state0, for the cotangents ``do`` of o (B, T, H,
    V) and ``dstate`` of the final state (B, H, K, V; None reads as 0) ->
    (dr, dk, dv, dlog_w, du, dstate0) in their inputs' dtypes, du None
    when u is None and dstate0 None when state0 is None.

    Float64 inputs are differentiated in float64, everything else in
    float32.  log_w is clamped at float32(-60/c) for the chunk c = min(chunk,
    T), as the forward does, and its gradient is 0 where the clamp binds
    (as ``torch.clamp``'s: it passes at the bounds themselves).

    Per chunk, with P the inclusive cumulative sum of the clamped log_w,
    Pq = P (post-update) or P - log_w (pre-update), q = r exp(Pq),
    kap = k exp(-P), kt = k exp(P_last - P), d = exp(P_last), the state S
    before the chunk and G the gradient of the state after it:
    dA = dO v^T and A = q kap^T under the causal mask M (the bonus
    r.(u*k) on A's diagonal in pre-update); dq = dO S^T + (dA*M) kap,
    dkap = (dA*M)^T q, dv = A^T dO + kt G, dkt = v G^T, dd = sum_v G*S;
    dP = dq*q - dkap*kap - dkt*kt, plus sum(dkt*kt) + dd*d on the last
    row; dlog_w is the reverse cumulative sum of dP, less dq*q in
    pre-update; the gradient before the chunk is d*G + q^T dO.  A reverse
    loop over the chunks, after a forward loop that keeps the state before
    each."""
    B, T, H, K = r.shape
    V = v.shape[-1]
    c = min(chunk, T)
    nc = T // c
    if nc * c != T:
        raise ValueError(f"T={T} not divisible by chunk={c}")
    dt = torch.float64 if r.dtype == torch.float64 else torch.float32
    rf, kf, vf, dof = (t.to(dt) for t in (r, k, v, do))
    lo = float(np.float32(-60.0 / c))
    raw = log_w.to(dt)
    lw = raw.clamp(lo, 0.0)
    passes = (raw >= lo) & (raw <= 0.0)
    uf = None if u is None else u.to(dt)
    S = torch.zeros((B, H, K, V), dtype=dt, device=r.device) \
        if state0 is None else state0.to(dt)
    idx = torch.arange(c, device=r.device)
    tri = (idx[:, None] >= idx[None, :] if post_update
           else idx[:, None] > idx[None, :]).to(dt)
    chunks = [slice(n * c, (n + 1) * c) for n in range(nc)]
    before = []
    for sl in chunks:  # the state before each chunk
        before.append(S)
        P = torch.cumsum(lw[:, sl], dim=1)
        S = S * torch.exp(P[:, -1])[..., None] + torch.einsum(
            "bchk,bchv->bhkv", kf[:, sl] * torch.exp(P[:, -1:] - P),
            vf[:, sl])
    G = torch.zeros_like(S) if dstate is None else dstate.to(dt)
    dr, dk, dlw = (torch.empty_like(lw) for _ in range(3))
    dv = torch.empty_like(vf)
    du = None if u is None else torch.zeros_like(uf)
    for n in reversed(range(nc)):
        sl, S = chunks[n], before[n]
        rb, kb, vb, lwb, dob = rf[:, sl], kf[:, sl], vf[:, sl], lw[:, sl], \
            dof[:, sl]
        P = torch.cumsum(lwb, dim=1)
        eq = torch.exp(P if post_update else P - lwb)
        en = torch.exp(-P)
        el = torch.exp(P[:, -1:] - P)
        d = torch.exp(P[:, -1])                          # (B, H, K)
        q, kap, kt = rb * eq, kb * en, kb * el
        A = torch.einsum("bihk,bjhk->bhij", q, kap) * tri
        dA = torch.einsum("bihv,bjhv->bhij", dob, vb)
        dAM = dA * tri
        if uf is not None:
            A = A + torch.diag_embed(torch.einsum("bihk,hk,bihk->bhi", rb,
                                                  uf, kb))
        dq = torch.einsum("bihv,bhkv->bihk", dob, S) + torch.einsum(
            "bhij,bjhk->bihk", dAM, kap)
        dkap = torch.einsum("bhij,bihk->bjhk", dAM, q)
        dv[:, sl] = torch.einsum("bhij,bihv->bjhv", A, dob) + torch.einsum(
            "bjhk,bhkv->bjhv", kt, G)
        dkt = torch.einsum("bjhv,bhkv->bjhk", vb, G)
        dd = (G * S).sum(-1)
        dr[:, sl] = dq * eq
        dk[:, sl] = dkap * en + dkt * el
        dPq = dq * q
        dP = dPq - dkap * kap - dkt * kt
        dP[:, -1] += (dkt * kt).sum(1) + dd * d
        dl = torch.flip(torch.cumsum(torch.flip(dP, [1]), 1), [1])
        dlw[:, sl] = dl if post_update else dl - dPq
        if uf is not None:  # the bonus r.(u*k) v
            db = torch.diagonal(dA, dim1=-2, dim2=-1).transpose(1, 2)[
                ..., None]                               # (B, c, H, 1)
            dr[:, sl] += db * uf * kb
            dk[:, sl] += db * uf * rb
            du += (db * rb * kb).sum((0, 1))
        G = G * d[..., None] + torch.einsum("bihk,bihv->bhkv", q, dob)
    dlw = dlw * passes
    return (dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype),
            dlw.to(log_w.dtype), None if u is None else du.to(u.dtype),
            None if state0 is None else G.to(state0.dtype))
