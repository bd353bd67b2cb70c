"""Int8 gradient compression with error feedback, as the JAX package's
``training/grad_compression.py``.

Per-tensor symmetric quantization: q = round(g / s) with s = max|g| / 127;
the quantization residual is carried in an ``error_feedback`` buffer and
re-injected next step (EF-SGD), which keeps convergence unbiased to first
order.  ``torch.round`` rounds half to even, as ``jnp.round`` does, so q
and s are bit-equal to the reference's on the same float32 input.
"""
from __future__ import annotations

import torch

from ..tree import tree_map


def quantize(g: torch.Tensor, bits: int = 8):
    qmax = 2.0 ** (bits - 1) - 1
    scale = torch.max(torch.abs(g)) / qmax
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(g / scale), -qmax, qmax).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_decompress(grads, opt_state, bits: int = 8):
    """Apply quantize -> dequantize with error feedback.  Returns
    (compressed grads, opt_state with updated error_feedback)."""
    ef = opt_state.get("error_feedback")
    if ef is None:
        ef = tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                            device=g.device), grads)

    def one(g, e):
        gf = g.float() + e
        q, s = quantize(gf, bits)
        deq = dequantize(q, s)
        return deq, gf - deq

    outs = tree_map(one, grads, ef)
    new_state = dict(opt_state)
    new_state["error_feedback"] = tree_map(lambda _, o: o[1], grads, outs)
    return tree_map(lambda _, o: o[0], grads, outs), new_state
