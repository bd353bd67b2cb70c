"""The MAESTRO DSE inner loop: a hand-written CUDA kernel for Hopper and
its plain PyTorch version.

Each design point is 2 scalars (num_pes int32, noc_bw float32) and a
closed-form evaluation over the static tables of ``tables.py``; it writes 5
float32 features.  That is 28 bytes of device memory traffic per design,
and the kernel's bound is N × 28 B over the card's memory bandwidth.  What
kept the first kernel from it was not its stores but its arithmetic, some
500 instructions a design (the float floor divisions, int32 division by
divisors known only at run time), one design a thread, not overlapped
with the stores (``scripts/ablate_maestro_eval.py``).  The kernel shares
the terms of a PE count among the consecutive designs a thread takes,
takes each remainder from one division and one fma, exactly, divides by
the table's constants with a multiply and a shift (``_floor_div``), and
stores each warp's rows, staged, 16 bytes wide.

``maestro_eval`` is the kernel's wrapper (source: ``csrc/maestro_eval.cu``,
built with ``nvcc`` at first use into ``build/repro_torch/`` at the root of
the checkout and bound with ``ctypes``).  ``closed_form_features`` is the
plain version: the wrapper's path for CPU tensors and the oracle the CUDA
kernel is held against on the card.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np
import torch

from .. import _build
from ...core.cluster_analysis import floor_divide as _floor_divide
from .tables import EvalTables

FEATURES = ("runtime", "macs", "throughput", "util", "bw_req")

SRC = Path(__file__).resolve().parent / "csrc" / "maestro_eval.cu"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")


# ----------------------------------------------------------------------
# Plain PyTorch version
# ----------------------------------------------------------------------

def _cdiv(a, b):
    if a.is_floating_point():
        return _floor_divide(a + b - 1, b)
    return torch.floor_divide(a + b - 1, b)


def _comm(v, bw, lat):
    d = _floor_divide(v + bw - 1.0, bw) + lat
    return torch.where(v > 0, d, 0.0)


def closed_form_features(pes: torch.Tensor, bw: torch.Tensor,
                         T: EvalTables) -> torch.Tensor:
    """pes int32[N], bw float32[N] -> float32[N, 5].  Exactly the faithful
    engine's single-level analysis (model.py) in closed form, op for op
    as the reference computes it (floor division of floats by
    ``jnp.floor_divide``'s rule: ``_floor_divide``)."""
    n = pes.to(torch.int32)
    f32 = torch.float32
    o, s, D = T.sp_o, T.sp_s, T.sp_D
    adv = n * o
    span = s + (n - 1) * o
    n_folds = 1 + _cdiv(torch.clamp(D - span, min=0), adv)
    rem = torch.minimum(D - (n_folds - 1) * adv, span)
    used = torch.minimum(n, _cdiv(rem, o))
    full = torch.minimum(used, torch.clamp((rem - s) // o + 1, min=0))
    partial_cnt = used - full
    last_partial = torch.clamp(rem - full * o, 0, s)
    partial = torch.where(partial_cnt > 0, last_partial, 0)
    is_steady = (full == n).to(torch.int32)
    steady_folds = n_folds - 1 + is_steady
    edge_folds = 1 - is_steady
    folds = n_folds

    steps_total = (T.temporal_steps * folds).to(f32)
    span_e = torch.clamp(span, max=D)
    ext_span = T.ext_of(span_e).to(f32)
    ext_partial = T.ext_of(partial).to(f32)

    delta = T.delta_a + T.delta_b * span_e.to(f32)
    ing_full = T.ing_full_a + T.ing_full_b * span_e.to(f32)
    egress = T.egress_a + T.egress_b * ext_span
    if T.o_coupled_spatial:
        egress = egress * folds.to(f32)
    step_eg = _cdiv(egress, torch.clamp(steps_total, min=1.0))

    lat = T.noc_latency
    ing_sd = _comm(delta, bw, lat)
    egr_sd = _comm(step_eg, bw, lat)
    fwd = torch.ceil(torch.log2(torch.clamp(n, min=1).to(f32))) \
        if T.spatial_reduces else torch.zeros_like(bw)

    runtime = torch.zeros_like(bw)
    macs = torch.zeros_like(bw)
    active_steps = torch.zeros_like(bw)
    comp_first = None
    nf = n.to(f32)
    fullf = full.to(f32)
    sfolds = steady_folds.to(f32)
    efolds = edge_folds.to(f32)
    for row in T.cases:
        comp = float(np.float32(row.psums_full))
        if comp_first is None:
            comp_first = torch.full_like(bw, comp)
        delay = torch.maximum(torch.maximum(comp + fwd, ing_sd), egr_sd)
        runtime = runtime + row.occ * folds.to(f32) * delay
        ps_partial = row.psums_per_ext * ext_partial
        macs = macs + row.occ * (
            sfolds * nf * row.psums_full
            + efolds * (fullf * row.psums_full + ps_partial))
        has_p = (partial > 0).to(f32)
        active_steps = active_steps + row.occ * (
            sfolds * nf + efolds * (fullf + has_p))

    serial = _comm(ing_full, bw, lat) + comp_first + fwd + egr_sd
    overlapped = torch.maximum(torch.maximum(comp_first + fwd, ing_sd),
                               egr_sd)
    runtime = torch.clamp(runtime + serial - overlapped, min=1.0)

    total_steps_pe = steps_total * nf
    util = active_steps / torch.clamp(total_steps_pe, min=1.0)
    thr = macs / runtime
    bw_req = (delta + step_eg) / torch.clamp(comp_first, min=1.0)
    return torch.stack([runtime, macs, thr, util, bw_req], dim=-1)


# ----------------------------------------------------------------------
# The CUDA kernel: build, bind, launch
# ----------------------------------------------------------------------

class _FloorDiv(ctypes.Structure):
    """Mirror of ``FloorDiv`` in ``csrc/maestro_eval.cu``: floor(a / d) as
    (a * magic) >> shift (``_floor_div``)."""
    _fields_ = [("d", ctypes.c_int32), ("magic", ctypes.c_uint32),
                ("shift", ctypes.c_uint32)]


class _Tables(ctypes.Structure):
    """Mirror of ``MaestroTables`` in ``csrc/maestro_eval.cu`` (passed by
    value; 21 four-byte fields, two ``FloorDiv`` of three among them, no
    padding).  A layout that does not match gives wrong numbers, not a
    crash."""
    _fields_ = [("sp_D", ctypes.c_int32), ("sp_s", ctypes.c_int32),
                ("o", _FloorDiv), ("conv_kind", ctypes.c_int32),
                ("sp_window", ctypes.c_int32), ("stride", _FloorDiv)] + [
        (f, ctypes.c_int32) for f in (
            "spatial_reduces", "o_coupled_spatial", "temporal_steps",
            "n_cases")] + [(f, ctypes.c_float) for f in (
                "delta_a", "delta_b", "ing_full_a", "ing_full_b",
                "egress_a", "egress_b", "noc_latency")]


def _floor_div(d: int) -> _FloorDiv:
    """The kernel's floor division by a constant ``d`` >= 1: for
    0 <= x < 2^31, x // d == (x * magic) >> shift with shift = 31 +
    ceil(log2 d) and magic = ceil(2^shift / d), which is below 2^32 (the
    proof is at ``floordiv_magic`` in the source)."""
    if not 1 <= d < 2 ** 31:
        raise ValueError(f"maestro_eval: the kernel divides by a table "
                         f"constant >= 1, got {d}")
    shift = 31 + (d - 1).bit_length()
    return _FloorDiv(d=d, magic=-(-(1 << shift) // d), shift=shift)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load(SRC, NVCC_FLAGS)
    fn = lib.maestro_eval_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int64, _Tables, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _c_tables(T: EvalTables) -> _Tables:
    return _Tables(
        sp_D=T.sp_D, sp_s=T.sp_s, o=_floor_div(T.sp_o),
        conv_kind=int(T.sp_kind == "conv"), sp_window=T.sp_window,
        stride=_floor_div(T.sp_stride),
        spatial_reduces=int(T.spatial_reduces),
        o_coupled_spatial=int(T.o_coupled_spatial),
        temporal_steps=T.temporal_steps, n_cases=len(T.cases),
        delta_a=T.delta_a, delta_b=T.delta_b, ing_full_a=T.ing_full_a,
        ing_full_b=T.ing_full_b, egress_a=T.egress_a, egress_b=T.egress_b,
        noc_latency=T.noc_latency)


@functools.lru_cache(maxsize=256)
def _device_cases(T: EvalTables, device: torch.device) -> torch.Tensor:
    """The case rows as float32[n_cases, 3] (occ, psums_full,
    psums_per_ext) on ``device``: the values the reference's weak typing
    turns each row's Python numbers into."""
    rows = [(r.occ, r.psums_full, r.psums_per_ext) for r in T.cases]
    return torch.tensor(rows, dtype=torch.float32,
                        device=device).reshape(-1, 3).contiguous()


def maestro_eval(pes: torch.Tensor, bw: torch.Tensor, *,
                 tables: EvalTables) -> torch.Tensor:
    """pes int32[N], bw float32[N], both contiguous on one device ->
    features float32[N, 5].  Replaces the reference's Pallas
    ``maestro_eval``.  CUDA tensors launch the CUDA kernel (counted in
    ``maestro_eval.launches``); CPU tensors take the plain version.  Raises
    on any input the kernel does not take: there is no fallback from the
    card.  Requires pes >= 1 (as ``DSEConfig`` does)."""
    if not (isinstance(pes, torch.Tensor) and isinstance(bw, torch.Tensor)):
        raise TypeError("maestro_eval takes torch tensors")
    if pes.device != bw.device:
        raise ValueError("maestro_eval: pes and bw must be on one device, "
                         f"got {pes.device} and {bw.device}")
    if pes.dtype != torch.int32 or bw.dtype != torch.float32:
        raise TypeError("maestro_eval: pes must be int32 and bw float32, "
                        f"got {pes.dtype} and {bw.dtype}")
    if pes.dim() != 1 or bw.shape != pes.shape:
        raise ValueError("maestro_eval: pes and bw must be 1-D of one "
                         f"length, got {tuple(pes.shape)} and "
                         f"{tuple(bw.shape)}")
    if pes.device.type == "cpu":
        return closed_form_features(pes, bw, tables)
    if pes.device.type != "cuda":
        raise ValueError(f"maestro_eval: no kernel for {pes.device}")
    if not (pes.is_contiguous() and bw.is_contiguous()):
        raise ValueError("maestro_eval: inputs must be contiguous")
    n = pes.shape[0]
    out = torch.empty((n, len(FEATURES)), dtype=torch.float32,
                      device=pes.device)
    if n == 0:
        return out
    fn = _library().maestro_eval_launch
    cases = _device_cases(tables, pes.device)
    with torch.cuda.device(pes.device):
        stream = torch.cuda.current_stream(pes.device).cuda_stream
        rc = fn(pes.data_ptr(), bw.data_ptr(), out.data_ptr(), n,
                _c_tables(tables), cases.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"maestro_eval kernel launch failed: CUDA error "
                           f"{rc}")
    maestro_eval.launches += 1
    return out


maestro_eval.launches = 0  # kernel launches since the last reset
