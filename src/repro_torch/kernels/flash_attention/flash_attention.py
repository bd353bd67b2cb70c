"""Causal or bidirectional GQA flash attention: the wrapper of a
hand-written CUDA kernel for Hopper.

``flash_attention`` replaces the JAX package's Pallas ``flash_attention``
(``src/repro/kernels/flash_attention/flash_attention.py:78``).  Its kernel
(``csrc/flash_attention.cu``) is compiled with ``nvcc`` for ``sm_90a`` at
first use into ``build/repro_torch/`` and bound with ``ctypes``; the source
note says what bounds it.  CUDA tensors launch the kernel, counted in
``flash_attention.launches``; CPU tensors take the plain version,
``attention_ref``.  Anything the kernel does not take raises, on either
device: there is no fallback from the card.

The kernel is invisible to autograd, so it refuses inputs that require a
gradient while grad mode is on (its gradient would otherwise be zero
without a word).
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np
import torch

from .. import _build
from .ref import attention_ref

SRC = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")
HEAD_DIMS = (16, 32, 64, 128)
TILES = ((64, 64), (128, 64))   # (blk_q, blk_k) the source is compiled for
DTYPES = (torch.float32, torch.bfloat16)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load(SRC, NVCC_FLAGS)
    fn = lib.flash_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _check(q, k, v, blk_q: int, blk_k: int) -> None:
    if not all(isinstance(t, torch.Tensor) for t in (q, k, v)):
        raise TypeError("flash_attention takes torch tensors")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k and v must be on one "
                         f"device, got {q.device}, {k.device}, {v.device}")
    if q.dtype not in DTYPES or not (q.dtype == k.dtype == v.dtype):
        raise TypeError("flash_attention: q, k and v must all be float32 "
                        f"or all bfloat16, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("flash_attention: q must be (B, Sq, Hq, D) and k, v "
                         f"(B, Sk, Hkv, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, Hq, D = q.shape
    Bk, Sk, Hkv, Dk = k.shape
    if Bk != B or Dk != D:
        raise ValueError("flash_attention: q and k differ in batch or head "
                         f"dim: {tuple(q.shape)} vs {tuple(k.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} not in {HEAD_DIMS}")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"flash_attention: Hq={Hq} is not a multiple of "
                         f"Hkv={Hkv}")
    if (blk_q, blk_k) not in TILES:
        raise ValueError(f"flash_attention: tile ({blk_q}, {blk_k}) not in "
                         f"{TILES}")
    if Sq % blk_q or Sk % blk_k:
        raise ValueError(f"flash_attention: Sq={Sq} and Sk={Sk} must be "
                         f"multiples of the tiles ({blk_q}, {blk_k})")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: inputs must be contiguous")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash_attention has no backward kernel yet: "
                           "call it under torch.no_grad() or on inputs "
                           "that do not require grad")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, blk_q: int = 64,
                    blk_k: int = 64) -> torch.Tensor:
    """q (B, Sq, Hq, D), k/v (B, Sk, Hkv, D) with Hq % Hkv == 0 ->
    (B, Sq, Hq, D) in q's dtype.  float32 or bfloat16, D in 16/32/64/128,
    Sq and Sk multiples of the (blk_q, blk_k) tile, contiguous tensors on
    one device."""
    _check(q, k, v, blk_q, blk_k)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for {q.device}")
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    fn = _library().flash_attention_launch
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                B, Sq, Sk, Hq, Hkv, D, int(q.dtype == torch.bfloat16),
                int(causal), blk_q, blk_k, float(np.float32(D ** -0.5)),
                stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {rc}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0  # kernel launches since the last reset
