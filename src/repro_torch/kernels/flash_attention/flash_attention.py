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

Under grad, ``flash_attention`` goes through ``_FlashAttention``, an
autograd function: its forward also has the kernel write each row's
log-sum-exp (``lse``, float32 (B, Hq, Sq)) and saves it beside q, k, v and
o; its backward is ``flash_attention_bwd``: on CUDA tensors the
hand-written kernels of ``csrc/flash_attention_bwd.cu`` (a library of
their own, built the same way; (dtype, D) picks the kernel as for the
forward: bfloat16 at D = 64 or 128 on the tensor cores, the rest the
float32 SIMT one), counted in ``flash_attention.bwd_launches``; on CPU
tensors ``attention_bwd_ref``.  The JAX package has no backward kernel:
XLA differentiates through its forward.  The backward is not
differentiable again.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np
import torch

from torch.autograd.function import once_differentiable

from .. import _build
from .ref import attention_bwd_ref, attention_ref

SRC = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
BWD_SRC = SRC.with_name("flash_attention_bwd.cu")
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
# the backward's (q, k) tiles: Sq and Sk must be multiples of them; bf16 at
# WGMMA_HEAD_DIMS runs the wgmma kernel (64 q rows, 128 keys a block)
BWD_SIMT_TILE = (64, 64)
BWD_WGMMA_TILE = (64, 128)


def tiles(dtype: torch.dtype, D: int) -> tuple[tuple[int, int], ...]:
    """The tiles of the kernel that (dtype, D) runs; the first is the
    default."""
    if dtype == torch.bfloat16 and D in WGMMA_HEAD_DIMS:
        return WGMMA_TILES
    return SIMT_TILES


def bwd_tile(dtype: torch.dtype, D: int) -> tuple[int, int]:
    """The (q, k) tile of the backward kernel that (dtype, D) runs."""
    if dtype == torch.bfloat16 and D in WGMMA_HEAD_DIMS:
        return BWD_WGMMA_TILE
    return BWD_SIMT_TILE


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load(SRC, NVCC_FLAGS)
    fn = lib.flash_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_library() -> ctypes.CDLL:
    lib = _build.load(BWD_SRC, NVCC_FLAGS)
    fn = lib.flash_attention_bwd_launch
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [
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
    device.  Under grad, with an input that requires it, the call is
    differentiable through ``flash_attention_bwd``."""
    blk_q, blk_k = _check(q, k, v, blk_q, blk_k)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, causal, blk_q, blk_k)
    return _forward(q, k, v, causal, blk_q, blk_k)[0]


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, causal: bool = True,
                             blk_q: int | None = None,
                             blk_k: int | None = None):
    """``flash_attention`` without autograd that also returns each row's
    log-sum-exp -> (o, lse), lse float32 (B, Hq, Sq): the forward that
    ``flash_attention_bwd`` takes its lse from."""
    blk_q, blk_k = _check(q, k, v, blk_q, blk_k)
    return _forward(q, k, v, causal, blk_q, blk_k, with_lse=True)


def _forward(q, k, v, causal: bool, blk_q: int, blk_k: int,
             with_lse: bool = False):
    """The checked forward -> (o, lse), lse None unless ``with_lse``: the
    kernel on CUDA tensors, ``attention_ref`` on CPU tensors."""
    if q.device.type == "cpu":
        if with_lse:
            return attention_ref(q, k, v, causal=causal, return_lse=True)
        return attention_ref(q, k, v, causal=causal), None
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for {q.device}")
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    out = torch.empty_like(q)
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32,
                      device=q.device) if with_lse else None
    if out.numel() == 0:
        return out, lse
    if lse is not None and Sk == 0:  # no keys: the kernel writes o alone
        lse.fill_(float("-inf"))
    fn = _library().flash_attention_launch
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                None if lse is None else lse.data_ptr(), B, Sq, Sk, Hq, Hkv,
                D, int(q.dtype == torch.bfloat16), int(causal), blk_q, blk_k,
                float(np.float32(D ** -0.5)), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"{_launch_error(rc)}")
    flash_attention.launches += 1
    return out, lse


class _FlashAttention(torch.autograd.Function):
    """``flash_attention`` under autograd: the forward kernel, writing
    lse beside o, then ``flash_attention_bwd`` on the saved q, k, v, o and
    lse."""

    @staticmethod
    def forward(ctx, q, k, v, causal, blk_q, blk_k):
        o, lse = _forward(q, k, v, causal, blk_q, blk_k, with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, do, lse=lse,
                                         causal=ctx.causal)
        return dq, dk, dv, None, None, None


def _check_bwd(q, k, v, o, do, lse) -> None:
    """Raises on what the backward kernel for (dtype, D) does not take."""
    ts = (q, k, v, o, do)
    if not all(isinstance(t, torch.Tensor) for t in ts) or not (
            lse is None or isinstance(lse, torch.Tensor)):
        raise TypeError("flash_attention_bwd takes torch tensors")
    if len({t.device for t in ts + ((lse,) if lse is not None else ())}) != 1:
        raise ValueError("flash_attention_bwd: q, k, v, o, do and lse must "
                         "be on one device")
    if q.dtype not in DTYPES or len({t.dtype for t in ts}) != 1:
        raise TypeError("flash_attention_bwd: q, k, v, o and do must all be "
                        "float32 or all bfloat16, got "
                        f"{[str(t.dtype) for t in ts]}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape or \
            o.shape != q.shape or do.shape != q.shape:
        raise ValueError("flash_attention_bwd: q, o and do must be (B, Sq, "
                         "Hq, D) and k, v (B, Sk, Hkv, D), got "
                         f"{[tuple(t.shape) for t in ts]}")
    B, Sq, Hq, D = q.shape
    Bk, Sk, Hkv, Dk = k.shape
    if Bk != B or Dk != D or D not in HEAD_DIMS or Hkv == 0 or Hq % Hkv:
        raise ValueError("flash_attention_bwd: needs one batch and head dim "
                         f"in {HEAD_DIMS} and Hq a multiple of Hkv, got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    bq, bk = bwd_tile(q.dtype, D)
    if Sq % bq or Sk % bk:
        raise ValueError(f"flash_attention_bwd: Sq={Sq} and Sk={Sk} must be "
                         f"multiples of {bq} and {bk} for {q.dtype} at head "
                         f"dim {D}")
    if lse is not None and (lse.dtype != torch.float32 or
                            tuple(lse.shape) != (B, Hq, Sq)):
        raise ValueError("flash_attention_bwd: lse must be float32 (B, Hq, "
                         f"Sq) = {(B, Hq, Sq)}, got {lse.dtype} "
                         f"{tuple(lse.shape)}")


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, *,
                        lse: torch.Tensor | None = None,
                        causal: bool = True):
    """The gradient of ``flash_attention``: q, o and do (B, Sq, Hq, D), k/v
    (B, Sk, Hkv, D), o the forward's output, do the gradient of the loss
    with respect to it and lse the forward's row log-sum-exp (float32,
    (B, Hq, Sq)) -> (dq, dk, dv) in the inputs' dtypes.  float32 or
    bfloat16, D in 16/32/64/128, Sq and Sk multiples of ``bwd_tile(dtype,
    D)``.  CUDA tensors launch the kernels (delta, then the gradients;
    counted once in ``flash_attention.bwd_launches``) and need lse; CPU
    tensors take ``attention_bwd_ref``, which computes lse where it is
    not given."""
    _check_bwd(q, k, v, o, do, lse)
    if q.device.type == "cpu":
        return attention_bwd_ref(q, k, v, o, do, causal=causal, lse=lse)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd: no kernel for {q.device}")
    if lse is None:
        raise ValueError("flash_attention_bwd: the kernel takes the "
                         "forward's lse (flash_attention_with_lse)")
    q, k, v, o, do, lse = (t.contiguous() for t in (q, k, v, o, do, lse))
    if any(t.data_ptr() % 16 for t in (q, k, v, o, do, lse)):
        raise ValueError("flash_attention_bwd: the kernels' TMA and 16-byte "
                         "loads need 16-byte aligned tensors")
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0 or k.numel() == 0:
        return dq.to(q.dtype), dk.zero_(), dv.zero_()
    delta = torch.empty_like(lse)
    fn = _bwd_library().flash_attention_bwd_launch
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), B, Sq, Sk, Hq, Hkv, D,
                int(q.dtype == torch.bfloat16), int(causal),
                float(np.float32(D ** -0.5)), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: "
                           f"{_launch_error(rc)}")
    flash_attention.bwd_launches += 1
    return dq.to(q.dtype), dk, dv


flash_attention.launches = 0  # forward kernel launches since the last reset
flash_attention.bwd_launches = 0  # backward launches (flash_attention_bwd)
