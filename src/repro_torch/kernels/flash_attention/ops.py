"""Attention that runs where its inputs lie."""
from __future__ import annotations

import torch

from ...devices import input_device
from .flash_attention import flash_attention


def attention(q, k, v, *, causal: bool = True,
              device: str | torch.device | None = None) -> torch.Tensor:
    """q (B,Sq,Hq,D), k/v (B,Sk,Hkv,D).  CUDA tensors launch the kernel,
    CPU tensors take ``attention_ref`` (``flash_attention`` decides).
    Inputs that are not tensors are moved to ``device``, ``cuda`` unless
    the caller asks for another."""
    dev = input_device(q, device, "attention")
    q, k, v = (torch.as_tensor(t, device=dev) for t in (q, k, v))
    return flash_attention(q, k, v, causal=causal)
