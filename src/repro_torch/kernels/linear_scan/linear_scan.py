"""Chunked linear attention (the RWKV-6 / Mamba-2 recurrence): the wrapper
of hand-written CUDA kernels for Hopper.

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

Under grad, with an input that requires it, ``linear_scan`` goes through
``_LinearScan``, an autograd function: its forward keeps the kernel's
scratch (the state before each tile and each tile's decay) beside the
inputs, and its backward is ``linear_scan_bwd``: on CUDA tensors the
hand-written kernels of ``csrc/linear_scan_bwd.cu`` (a library of their
own, built the same way: a reverse state pass, a reverse hand-off and a
gradient pass), counted once a call in ``linear_scan_bwd.launches``; on
CPU tensors ``linear_scan_bwd_ref``.  The JAX package has no backward
kernel: XLA differentiates its model's ``chunked_linear_attn``.  The
backward is not differentiable again.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np
import torch

from torch.autograd.function import once_differentiable

from .. import _build
from .ref import linear_scan_bwd_ref, linear_scan_ref

SRC = Path(__file__).resolve().parent / "csrc" / "linear_scan.cu"
BWD_SRC = SRC.with_name("linear_scan_bwd.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")
DTYPES = (torch.float32, torch.bfloat16)
MAX_K = 64        # key width the kernel's shared memory is sized for
MAX_CHUNK = 256   # longest chunk the kernel is written and tested for


@functools.lru_cache(maxsize=None)
def _library(src: Path = SRC) -> ctypes.CDLL:
    """The forward's library (``src``: another copy of the source, e.g. an
    ablation's variant), its functions declared."""
    lib = _build.load(src, NVCC_FLAGS)
    args = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 + [ctypes.c_float,
                                                          ctypes.c_void_p]
    lib.linear_scan_launch.argtypes = args
    lib.linear_scan_pass.argtypes = [ctypes.c_int] + args
    for fn in (lib.linear_scan_launch, lib.linear_scan_pass):
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_library(src: Path = BWD_SRC) -> ctypes.CDLL:
    """The backward's library, as ``_library``."""
    lib = _build.load(src, NVCC_FLAGS)
    args = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 9 + [ctypes.c_float,
                                                           ctypes.c_void_p]
    lib.linear_scan_bwd_launch.argtypes = args
    lib.linear_scan_bwd_pass.argtypes = [ctypes.c_int] + args
    lib.linear_scan_bwd_grad_occupancy.argtypes = [ctypes.c_int] + [
        ctypes.POINTER(ctypes.c_int)] * 2
    for fn in (lib.linear_scan_bwd_launch, lib.linear_scan_bwd_pass,
               lib.linear_scan_bwd_grad_occupancy):
        fn.restype = ctypes.c_int
    return lib


def bwd_grad_occupancy(dtype: torch.dtype) -> tuple[int, int]:
    """(dynamic shared bytes, blocks an SM holds at once) of the
    backward's gradient pass for ``dtype``'s instance, as the CUDA runtime
    counts them on the current card (registers and shared memory)."""
    smem, blocks = ctypes.c_int(), ctypes.c_int()
    rc = _bwd_library().linear_scan_bwd_grad_occupancy(
        int(dtype == torch.bfloat16), ctypes.byref(smem), ctypes.byref(blocks))
    if rc != 0:
        raise RuntimeError(f"linear_scan_bwd occupancy query failed: CUDA "
                           f"error {rc}")
    return smem.value, blocks.value


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


def _check_kernel(r, v, chunk: int) -> None:
    """Raises on a CUDA shape the kernels do not take."""
    K, V, c = r.shape[-1], v.shape[-1], min(chunk, r.shape[1])
    if not (1 <= K <= MAX_K and V >= 1 and c <= MAX_CHUNK):
        raise ValueError(f"linear_scan: the kernel takes 1 <= K <= {MAX_K}, "
                         f"V >= 1 and chunks <= {MAX_CHUNK}, got K={K}, "
                         f"V={V}, chunk={c}")


def linear_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                log_w: torch.Tensor, u: torch.Tensor | None = None,
                state0: torch.Tensor | None = None, *, chunk: int = 64,
                post_update: bool = False):
    """r/k/log_w (B, T, H, K), v (B, T, H, V), u (H, K) or None, state0
    (B, H, K, V) or None -> (o (B, T, H, V) in r's dtype, state (B, H, K, V)
    float32).  r, k, v float32 or bfloat16; c = min(chunk, T) must divide
    T; on the card K <= 64 and c <= 256.  Under grad, with an input that
    requires it, the call is differentiable through ``linear_scan_bwd``."""
    _check(r, k, v, log_w, u, state0, chunk)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (r, k, v, log_w, u, state0)):
        return _LinearScan.apply(r, k, v, log_w, u, state0, chunk,
                                 post_update)
    return _forward(r, k, v, log_w, u, state0, chunk, post_update)[:2]


def linear_scan_with_states(r, k, v, log_w, u=None, state0=None, *,
                            chunk: int = 64, post_update: bool = False):
    """``linear_scan`` without autograd that also returns the kernel's
    scratch -> (o, state, states): the state before each tile and each
    tile's decay, float32 B H nt K (V + 1) (nt = T/c ceil(c/64)), which
    ``linear_scan_bwd`` takes on the card; None on CPU tensors."""
    _check(r, k, v, log_w, u, state0, chunk)
    return _forward(r, k, v, log_w, u, state0, chunk, post_update)


def _forward(r, k, v, log_w, u, state0, chunk: int, post_update: bool):
    """The checked forward -> (o, state, states): the kernel on CUDA
    tensors, ``linear_scan_ref`` (states None) on CPU tensors."""
    if r.device.type == "cpu":
        with torch.no_grad():
            o, state = linear_scan_ref(r, k, v, log_w, u=u, state0=state0,
                                       chunk=chunk, post_update=post_update)
        return o.to(r.dtype), state, None
    if r.device.type != "cuda":
        raise ValueError(f"linear_scan: no kernel for {r.device}")
    _check_kernel(r, v, chunk)
    o, state, args, keep = launch_args(r, k, v, log_w, u, state0,
                                       min(chunk, r.shape[1]), post_update)
    if r.shape[0] * r.shape[2]:
        with torch.cuda.device(r.device):
            rc = _library().linear_scan_launch(*args)
        if rc != 0:
            raise RuntimeError(f"linear_scan kernel launch failed: CUDA "
                               f"error {rc}")
        linear_scan.launches += 1
    return o, state, keep[-1]


class _LinearScan(torch.autograd.Function):
    """``linear_scan`` under autograd: the forward kernel, keeping its
    scratch, then ``linear_scan_bwd`` on the saved inputs and scratch."""

    @staticmethod
    def forward(ctx, r, k, v, log_w, u, state0, chunk, post_update):
        o, state, states = _forward(r, k, v, log_w, u, state0, chunk,
                                    post_update)
        ctx.save_for_backward(r, k, v, log_w, u, state0, states)
        ctx.chunk, ctx.post_update = chunk, post_update
        ctx.set_materialize_grads(False)
        return o, state

    @staticmethod
    @once_differentiable
    def backward(ctx, do, dstate):
        r, k, v, log_w, u, state0, states = ctx.saved_tensors
        if do is None:
            do = torch.zeros(v.shape, dtype=r.dtype, device=r.device)
        grads = linear_scan_bwd(r, k, v, log_w, u, state0, do, dstate,
                                chunk=ctx.chunk,
                                post_update=ctx.post_update, states=states)
        return (*grads, None, None)


def linear_scan_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    log_w: torch.Tensor, u: torch.Tensor | None,
                    state0: torch.Tensor | None, do: torch.Tensor,
                    dstate: torch.Tensor | None = None, *, chunk: int = 64,
                    post_update: bool = False,
                    states: torch.Tensor | None = None):
    """The gradient of ``linear_scan``: its inputs, ``do`` the gradient of
    the loss with respect to o (in r's dtype, v's shape), ``dstate`` with
    respect to the final state ((B, H, K, V); None reads as 0), and
    ``states`` the forward's scratch (``linear_scan_with_states``) ->
    (dr, dk, dv, dlog_w, du, dstate0) in their inputs' dtypes, du None when
    u is None and dstate0 None when state0 is None; log_w's gradient is 0
    where the -60/c clamp binds.  CUDA tensors launch the kernels (reverse
    state pass, reverse hand-off, gradient pass; counted once in
    ``linear_scan_bwd.launches``) and need ``states``; CPU tensors take
    ``linear_scan_bwd_ref``."""
    _check(r, k, v, log_w, u, state0, chunk)
    B, T, H, K = r.shape
    V = v.shape[-1]
    if not isinstance(do, torch.Tensor) or do.shape != v.shape or \
            do.dtype != r.dtype or do.device != r.device:
        raise ValueError(f"linear_scan_bwd: do must be {r.dtype} "
                         f"{tuple(v.shape)} on {r.device}")
    if dstate is not None and (not isinstance(dstate, torch.Tensor) or
                               dstate.shape != (B, H, K, V) or
                               not dstate.is_floating_point() or
                               dstate.device != r.device):
        raise ValueError(f"linear_scan_bwd: dstate must be a floating "
                         f"({B}, {H}, {K}, {V}) tensor on {r.device}")
    if r.device.type == "cpu":
        return linear_scan_bwd_ref(r, k, v, log_w, u, state0, do, dstate,
                                   chunk=chunk, post_update=post_update)
    if r.device.type != "cuda":
        raise ValueError(f"linear_scan_bwd: no kernel for {r.device}")
    _check_kernel(r, v, chunk)
    c = min(chunk, T)
    nt = T // c * -(-c // 64)
    if states is None or states.dtype != torch.float32 or \
            states.device != r.device or \
            states.numel() != B * H * nt * K * (V + 1):
        raise ValueError("linear_scan_bwd: the kernel takes the forward's "
                         "states (linear_scan_with_states): float32, "
                         f"{B * H * nt * K * (V + 1)} elements")
    dev = r.device
    ins = (r.contiguous(), k.contiguous(), v.contiguous(),
           log_w.to(torch.float32).contiguous(),
           None if u is None else u.to(torch.float32).contiguous(),
           do.contiguous(),
           None if dstate is None else dstate.to(torch.float32).contiguous(),
           states.contiguous())
    dr, dk, dv = (torch.empty_like(t) for t in ins[:3])
    dlw = torch.empty((B, T, H, K), dtype=torch.float32, device=dev)
    du_part = torch.zeros((B, H, nt, K), dtype=torch.float32, device=dev)
    ds0 = torch.zeros((B, H, K, V), dtype=torch.float32, device=dev)
    scratch = torch.empty(B * H * nt * K * V, dtype=torch.float32,
                          device=dev)
    if B * H:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = _bwd_library().linear_scan_bwd_launch(*bwd_args(
                *ins, scratch, dr, dk, dv, dlw, du_part, ds0, c,
                post_update, stream))
        if rc != 0:
            raise RuntimeError(f"linear_scan_bwd kernel launch failed: CUDA "
                               f"error {rc}")
        linear_scan_bwd.launches += 1
    du = None if u is None else du_part.sum((0, 2)).to(u.dtype)
    return (dr, dk, dv, dlw.to(log_w.dtype), du,
            None if state0 is None else ds0.to(state0.dtype))


def bwd_args(r, k, v, lw, uf, do, dsT, states, scratch, dr, dk, dv, dlw,
             du_part, ds0, c: int, post_update: bool, stream) -> tuple:
    """The C arguments of ``linear_scan_bwd_launch`` (and, after ``which``,
    of ``linear_scan_bwd_pass``: 0 reverse state pass, 1 reverse hand-off,
    2 gradient pass) for checked, contiguous CUDA tensors; ``uf`` and
    ``dsT`` may be None."""
    B, T, H, K = r.shape

    def ptr(t):
        return None if t is None else t.data_ptr()
    return (*map(ptr, (r, k, v, lw, uf, do, dsT, states, scratch, dr, dk, dv,
                       dlw, du_part, ds0)),
            B, T, H, K, v.shape[-1], c, int(r.dtype == torch.bfloat16),
            int(post_update), int(uf is not None),
            float(np.float32(-60.0 / c)), stream)


def launch_args(r, k, v, log_w, u, state0, c: int, post_update: bool):
    """(o, state, the C arguments of ``linear_scan_launch``, the tensors
    they point at) for checked CUDA inputs and chunk ``c``: the outputs and
    the scratch of the passes (each tile's state and decay, B H nt K (V +
    1) floats for the nt = T/c ceil(c/64) tiles of up to 64 rows)
    allocated with ``torch.empty``, on the current stream.  Hold the last
    item, whose last tensor is the scratch, until the launch is enqueued.
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
linear_scan_bwd.launches = 0  # backward kernel launches since the last reset
