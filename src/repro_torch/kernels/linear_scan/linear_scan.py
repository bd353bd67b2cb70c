"""Chunked linear attention (the RWKV-6 / Mamba-2 recurrence): the wrapper
of a hand-written CUDA kernel for Hopper.

``linear_scan`` replaces the JAX package's Pallas ``linear_scan``
(``src/repro/kernels/linear_scan/linear_scan.py:84``).  Its kernel
(``csrc/linear_scan.cu``: a state pass, the tile-to-tile hand-off and an
output pass, launched back to back) is compiled with ``nvcc`` for
``sm_90a`` at first use into ``build/repro_torch/`` and bound with
``ctypes``; the source note says what bounds it.  CUDA tensors launch the
kernel, counted once a call in ``linear_scan.launches``; CPU tensors take
the plain version,
``linear_scan_ref``, with o returned in r's dtype as on the card.  Strided
inputs are copied to contiguous ones.  Anything else the kernel does not
take raises: there is no fallback from the card.

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
from .ref import linear_scan_ref

SRC = Path(__file__).resolve().parent / "csrc" / "linear_scan.cu"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")
DTYPES = (torch.float32, torch.bfloat16)
MAX_K = 64        # key width the kernel's shared memory is sized for
MAX_CHUNK = 256   # longest chunk the kernel is written and tested for


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load(SRC, NVCC_FLAGS)
    args = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 + [ctypes.c_float,
                                                          ctypes.c_void_p]
    lib.linear_scan_launch.argtypes = args
    lib.linear_scan_pass.argtypes = [ctypes.c_int] + args
    for fn in (lib.linear_scan_launch, lib.linear_scan_pass):
        fn.restype = ctypes.c_int
    return lib


def _check(r, k, v, log_w, u, state0, chunk: int) -> None:
    given = [t for t in (r, k, v, log_w, u, state0) if t is not None]
    if not all(isinstance(t, torch.Tensor) for t in given):
        raise TypeError("linear_scan takes torch tensors")
    if len({t.device for t in given}) != 1:
        raise ValueError("linear_scan: all inputs must be on one device, "
                         f"got {sorted({str(t.device) for t in given})}")
    if r.dtype not in DTYPES or not (r.dtype == k.dtype == v.dtype):
        raise TypeError("linear_scan: r, k and v must all be float32 or all "
                        f"bfloat16, got {r.dtype}, {k.dtype}, {v.dtype}")
    if not all(t.is_floating_point() for t in given):
        raise TypeError("linear_scan: log_w, u and state0 must be floating")
    if r.dim() != 4 or k.shape != r.shape or log_w.shape != r.shape or \
            v.dim() != 4 or v.shape[:3] != r.shape[:3]:
        raise ValueError("linear_scan: r, k and log_w must be (B, T, H, K) "
                         f"and v (B, T, H, V), got {tuple(r.shape)}, "
                         f"{tuple(k.shape)}, {tuple(log_w.shape)}, "
                         f"{tuple(v.shape)}")
    B, T, H, K = r.shape
    V = v.shape[-1]
    if u is not None and u.shape != (H, K):
        raise ValueError(f"linear_scan: u must be ({H}, {K}), got "
                         f"{tuple(u.shape)}")
    if state0 is not None and state0.shape != (B, H, K, V):
        raise ValueError(f"linear_scan: state0 must be ({B}, {H}, {K}, {V}),"
                         f" got {tuple(state0.shape)}")
    if T == 0 or chunk < 1:
        raise ValueError(f"linear_scan: needs T >= 1 and chunk >= 1, got "
                         f"T={T}, chunk={chunk}")
    c = min(chunk, T)
    if T % c:
        raise ValueError(f"linear_scan: T={T} not divisible by chunk={c}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in given):
        raise RuntimeError("linear_scan has no backward kernel: call it "
                           "under torch.no_grad() or on inputs that do not "
                           "require grad")


def linear_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                log_w: torch.Tensor, u: torch.Tensor | None = None,
                state0: torch.Tensor | None = None, *, chunk: int = 64,
                post_update: bool = False):
    """r/k/log_w (B, T, H, K), v (B, T, H, V), u (H, K) or None, state0
    (B, H, K, V) or None -> (o (B, T, H, V) in r's dtype, state (B, H, K, V)
    float32).  r, k, v float32 or bfloat16; c = min(chunk, T) must divide
    T; on the card K <= 64 and c <= 256."""
    _check(r, k, v, log_w, u, state0, chunk)
    if r.device.type == "cpu":
        o, state = linear_scan_ref(r, k, v, log_w, u=u, state0=state0,
                                   chunk=chunk, post_update=post_update)
        return o.to(r.dtype), state
    if r.device.type != "cuda":
        raise ValueError(f"linear_scan: no kernel for {r.device}")
    B, T, H, K = r.shape
    V = v.shape[-1]
    c = min(chunk, T)
    if not (1 <= K <= MAX_K and V >= 1 and c <= MAX_CHUNK):
        raise ValueError(f"linear_scan: the kernel takes 1 <= K <= {MAX_K}, "
                         f"V >= 1 and chunks <= {MAX_CHUNK}, got K={K}, "
                         f"V={V}, chunk={c}")
    o, state, args, _keep = launch_args(r, k, v, log_w, u, state0, c,
                                        post_update)
    if B * H == 0:
        return o, state
    with torch.cuda.device(r.device):
        rc = _library().linear_scan_launch(*args)
    if rc != 0:
        raise RuntimeError(f"linear_scan kernel launch failed: CUDA error "
                           f"{rc}")
    linear_scan.launches += 1
    return o, state


def launch_args(r, k, v, log_w, u, state0, c: int, post_update: bool):
    """(o, state, the C arguments of ``linear_scan_launch``, the tensors
    they point at) for checked CUDA inputs and chunk ``c``: the outputs and
    the scratch of the passes (each tile's state and decay, B H nt K (V +
    1) floats for the nt = T/c ceil(c/64) tiles of up to 64 rows)
    allocated with ``torch.empty``, on the current stream.  Hold the last
    item until the launch is enqueued.
    ``linear_scan_pass(which, *args)`` runs one pass (0 state, 1 hand-off,
    2 output)."""
    B, T, H, K = r.shape
    V = v.shape[-1]
    dev = r.device
    r, k, v = r.contiguous(), k.contiguous(), v.contiguous()
    lw = log_w.to(torch.float32).contiguous()  # the Pallas kernel's f32 copy
    uf = None if u is None else u.to(torch.float32).contiguous()
    s0 = torch.zeros((B, H, K, V), dtype=torch.float32, device=dev) \
        if state0 is None else state0.to(torch.float32).contiguous()
    o = torch.empty((B, T, H, V), dtype=r.dtype, device=dev)
    state = torch.empty((B, H, K, V), dtype=torch.float32, device=dev)
    nt = T // c * -(-c // 64)  # tiles of up to 64 rows, none across chunks
    scratch = torch.empty(B * H * nt * K * (V + 1), dtype=torch.float32,
                          device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = (r.data_ptr(), k.data_ptr(), v.data_ptr(), lw.data_ptr(),
            None if uf is None else uf.data_ptr(), s0.data_ptr(),
            o.data_ptr(), state.data_ptr(), scratch.data_ptr(), B, T, H, K,
            V, c, int(r.dtype == torch.bfloat16), int(post_update),
            int(uf is not None), float(np.float32(-60.0 / c)), stream)
    return o, state, args, (r, k, v, lw, uf, s0, scratch)


linear_scan.launches = 0  # kernel launches since the last reset
