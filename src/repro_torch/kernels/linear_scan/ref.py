"""Plain PyTorch version of the linear-scan kernel: the model layer's
chunked implementation (``models/ssm.py``), as in the JAX package."""
from __future__ import annotations

from ...models.ssm import chunked_linear_attn


def linear_scan_ref(r, k, v, log_w, u=None, state0=None, *, chunk=64,
                    post_update=False):
    """Returns (o (B,T,H,V) float32, state (B,H,K,V) float32)."""
    return chunked_linear_attn(r, k, v, log_w, u=u, state0=state0,
                               chunk=chunk, post_update=post_update)
