"""Causal or bidirectional GQA flash attention: the wrapper of a
hand-written CUDA kernel for Hopper.

``flash_attention`` replaces the JAX package's Pallas ``flash_attention``
(``src/repro/kernels/flash_attention/flash_attention.py:78``).  Its source
(``csrc/flash_attention.cu``) is compiled with ``nvcc`` for ``sm_90a`` at
first use into ``build/repro_torch/`` and bound with ``ctypes``; the source
note says what bounds it.  It holds two kernels, and (dtype, D) alone picks
one: bfloat16 at D = 64 or 128 runs on the tensor cores (``wgmma`` fed by
TMA, 128-row q tiles, K/V tiles of ``WGMMA_TILES``); float32, and bfloat16
at D = 16 or 32 (only the ``.reduced()`` configs), run the float32 SIMT
kernel (``SIMT_TILES``).  CUDA tensors launch a kernel, counted in
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
WGMMA_HEAD_DIMS = (64, 128)  # bfloat16 at these runs the wgmma kernel
# (blk_q, blk_k) each kernel is compiled for; the first is the default
# (for the wgmma kernel, BK = 128 measured faster than 64 on the H100: the
# PERF.md kernel table)
SIMT_TILES = ((64, 64), (128, 64))
WGMMA_TILES = ((128, 128), (128, 64))
DTYPES = (torch.float32, torch.bfloat16)


def tiles(dtype: torch.dtype, D: int) -> tuple[tuple[int, int], ...]:
    """The tiles of the kernel that (dtype, D) runs; the first is the
    default."""
    if dtype == torch.bfloat16 and D in WGMMA_HEAD_DIMS:
        return WGMMA_TILES
    return SIMT_TILES


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load(SRC, NVCC_FLAGS)
    fn = lib.flash_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _check(q, k, v, blk_q: int | None,
           blk_k: int | None) -> tuple[int, int]:
    """Raises on what the kernel does not take; returns the tile, the
    default of ``tiles(dtype, D)`` where ``blk_q`` or ``blk_k`` is None.
    The wgmma kernel (bfloat16 at D = 64, 128) also needs 16-byte aligned
    CUDA tensors for its TMA loads; bfloat16 at D = 16, 32 stays on the
    SIMT kernel."""
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
    allowed = tiles(q.dtype, D)
    blk_q = allowed[0][0] if blk_q is None else blk_q
    blk_k = allowed[0][1] if blk_k is None else blk_k
    if (blk_q, blk_k) not in allowed:
        raise ValueError(f"flash_attention: tile ({blk_q}, {blk_k}) not in "
                         f"{allowed} for {q.dtype} at head dim {D}")
    if Sq % blk_q or Sk % blk_k:
        raise ValueError(f"flash_attention: Sq={Sq} and Sk={Sk} must be "
                         f"multiples of the tiles ({blk_q}, {blk_k})")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: inputs must be contiguous")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash_attention has no backward kernel yet: "
                           "call it under torch.no_grad() or on inputs "
                           "that do not require grad")
    if q.is_cuda and allowed is WGMMA_TILES and any(
            t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: the wgmma kernel's TMA loads "
                         "need 16-byte aligned tensors")
    return blk_q, blk_k


def _launch_error(rc: int) -> str:
    """The C launcher's return code in words (``csrc``'s ERR_*)."""
    if rc == -1:
        return "no kernel compiled for this head dim, tile and dtype"
    if rc == -2:
        return "libcuda.so.1 has no cuTensorMapEncodeTiled"
    if rc >= 2000:
        return f"cuTensorMapEncodeTiled refused a tensor map (CUresult " \
               f"{rc - 2000})"
    return f"CUDA error {rc}"


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, blk_q: int | None = None,
                    blk_k: int | None = None) -> torch.Tensor:
    """q (B, Sq, Hq, D), k/v (B, Sk, Hkv, D) with Hq % Hkv == 0 ->
    (B, Sq, Hq, D) in q's dtype.  float32 or bfloat16, D in 16/32/64/128,
    Sq and Sk multiples of the (blk_q, blk_k) tile, one of
    ``tiles(dtype, D)`` (its first by default), contiguous tensors on one
    device."""
    blk_q, blk_k = _check(q, k, v, blk_q, blk_k)
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
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"{_launch_error(rc)}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0  # kernel launches since the last reset
