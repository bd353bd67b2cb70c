"""Compile a (layer × single-level dataflow) into static coefficient
tables for the maestro_eval kernel.

Scope: single-cluster dataflows (no Cluster directive) with one SpatialMap
— the family the paper's DSE sweeps (and the hot path of Fig. 13).  All
temporal trip counts, per-case tile sizes and volume coefficients are
static; only (num_pes, noc_bw) vary per design point, so the kernel is a
closed-form evaluation over those two inputs.

Every volume is linear in the spatial dim's *level extent* e (tensors are
products of per-dim extents), so we extract (A + B·e) coefficients by
probing the trusted engine volumes at e ∈ {1, 2}.
"""
from __future__ import annotations

import dataclasses
import itertools

from ...core.cluster_analysis import py_backend, temporal_phases
from ...core.directives import Cluster, Dataflow, SpatialMap, complete, extended_dims
from ...core.reuse_analysis import psums_volume, tensor_volume
from ...core.tensor_analysis import ConvExpr, DimExpr, LayerOp


@dataclasses.dataclass(frozen=True)
class CaseRow:
    occ: int            # product of temporal phase counts
    psums_full: int     # per-unit MACs at full spatial extent s
    psums_per_ext: float  # MACs per unit of spatial iteration extent
    delta: float        # steady per-step ingress delta (A + B·e applied)
    delta_b: float


@dataclasses.dataclass(frozen=True)
class EvalTables:
    # spatial loop statics
    sp_D: int
    sp_s: int
    sp_o: int
    sp_kind: str        # 'dim' | 'conv'
    sp_window: int      # window taps (conv kind)
    sp_stride: int
    spatial_reduces: bool
    o_coupled_spatial: bool
    # temporal-case table
    cases: tuple[CaseRow, ...]
    # per-step steady ingress delta: A + B·span_ext
    delta_a: float
    delta_b: float
    # init full-tile ingress: A + B·span_ext
    ing_full_a: float
    ing_full_b: float
    # egress totals: (EG_A [+ ×folds if o_coupled_spatial]) ; o_tile coef
    egress_a: float
    egress_b: float     # × span_ext
    temporal_steps: int  # Π temporal trips (per fold)
    noc_latency: float = 2.0

    def ext_of(self, size):
        """Iteration extent contributed by a spatial tile of ``size``
        (an int32 tensor; ``//`` floors, as in the reference)."""
        import torch
        if self.sp_kind == "dim":
            return size
        valid = size >= self.sp_window
        return torch.where(valid,
                           (size - self.sp_window) // self.sp_stride + 1, 0)


def build_tables(op: LayerOp, df: Dataflow,
                 noc_latency: float = 2.0) -> EvalTables:
    xp = py_backend()
    dims = extended_dims(df, op.dims)
    cdf = complete(df, op.dims)
    if cdf.cluster_sizes:
        raise ValueError("maestro_eval kernel: single-level dataflows only")
    maps = cdf.levels[0]
    spatials = [d for d in maps if isinstance(d, SpatialMap)]
    if len(spatials) != 1:
        raise ValueError("maestro_eval kernel: exactly one SpatialMap")
    sp = spatials[0]
    sp_stride = op.stride_of(sp.dim)
    temporals = [d for d in maps if not isinstance(d, SpatialMap)]

    # spatial coupling kind w.r.t. the iteration space
    sp_kind, sp_window = "dim", 1
    for e in op.iter_entries:
        if isinstance(e, ConvExpr) and e.outer == sp.dim:
            sp_kind, sp_window = "conv", dims[e.window]

    red = op.reduction_dims()
    spatial_reduces = sp.dim in red
    o_coupled_spatial = op.output.coupled_to(sp.dim)

    # temporal phases (static)
    phase_lists = []
    for d in temporals:
        D = dims[d.dim]
        st, ed = temporal_phases(xp, D, min(d.size, D),
                                 d.offset * op.stride_of(d.dim))
        phase_lists.append((d, (st, ed)))

    sp_s = min(sp.size, dims[sp.dim])

    def span_tile(e: int) -> dict:
        m = dict(dims)
        for d, (st, _) in phase_lists:
            m[d.dim] = st.size
        m[sp.dim] = e
        return m

    # steady advancing loop = innermost temporal with >1 trips
    adv = None
    for d, (st, ed) in reversed(phase_lists):
        if st.count + ed.count > 1:
            adv = d
            break

    def delta_for(e: int) -> float:
        """Engine rule (reuse_analysis.analyze_level_traffic): overlap
        credit only when a tensor's innermost *coupled* loop IS the global
        advancing loop; otherwise the whole steady tile refetches."""
        m = span_tile(e)
        total = 0.0
        for t in op.input_tensors():
            coupled = [d for d in maps if t.coupled_to(d.dim)]
            if not coupled:
                continue
            inner = coupled[-1]
            if adv is not None and inner is adv:
                ov = {adv.dim: min(adv.offset * op.stride_of(adv.dim),
                                   m[adv.dim])}
                total += tensor_volume(t, m, xp, override=ov)
            else:
                total += tensor_volume(t, m, xp)
        return total

    def full_ing(e: int) -> float:
        m = span_tile(e)
        return float(sum(tensor_volume(t, m, xp)
                         for t in op.input_tensors()))

    d1, d2 = delta_for(1), delta_for(2)
    f1, f2 = full_ing(1), full_ing(2)

    # egress: tile_vol(O) × commits(temporal part) × spill; folds factor
    # applied in-kernel when the spatial dim couples O.
    commits = 1
    o_loops = [d for d, (st, ed) in phase_lists
               if op.output.coupled_to(d.dim)]
    spill = 1
    if o_loops:
        inner_o = o_loops[-1]
        seen_inner = False
        for d, (st, ed) in reversed(phase_lists):
            if d is inner_o:
                seen_inner = True
                continue
            if seen_inner and d.dim in red:
                spill *= st.count + ed.count
        for d, (st, ed) in phase_lists:
            if op.output.coupled_to(d.dim):
                commits *= st.count + ed.count
    # probe at iteration extents 1 and 2 (for conv-coupled spatial dims the
    # raw sizes giving those extents are w and w+stride)
    if sp_kind == "dim":
        e_ext1, e_ext2 = 1, 2
    else:
        e_ext1, e_ext2 = sp_window, sp_window + sp_stride
    ov1 = tensor_volume(op.output, span_tile(e_ext1), xp)
    ov2 = tensor_volume(op.output, span_tile(e_ext2), xp)
    eg_b = float((ov2 - ov1) * commits * spill)
    eg_a = float(ov1 * commits * spill - eg_b)

    # temporal case table
    rows = []
    t_steps = 1
    for d, (st, ed) in phase_lists:
        t_steps *= st.count + ed.count
    for choice in itertools.product(*[range(2) for _ in phase_lists]):
        occ = 1
        m = dict(dims)
        for (d, phases), ci in zip(phase_lists, choice):
            ph = phases[ci]
            occ *= ph.count
            m[d.dim] = ph.size
        if occ == 0:
            continue
        m1 = dict(m)
        m1[sp.dim] = sp_s
        ps_full = psums_volume(op, m1, xp)
        m2 = dict(m)
        # per-extent MACs: psums at extent 1 of the spatial iteration dim
        if sp_kind == "dim":
            m2[sp.dim] = 1
        else:
            m2[sp.dim] = sp_window  # one window = extent 1
        ps_unit = psums_volume(op, m2, xp)
        rows.append(CaseRow(occ=occ, psums_full=int(ps_full),
                            psums_per_ext=float(ps_unit),
                            delta=0.0, delta_b=0.0))

    return EvalTables(
        sp_D=dims[sp.dim], sp_s=sp_s, sp_o=sp.offset * sp_stride,
        sp_kind=sp_kind, sp_window=sp_window, sp_stride=sp_stride,
        spatial_reduces=spatial_reduces,
        o_coupled_spatial=o_coupled_spatial,
        cases=tuple(rows),
        delta_a=float(2 * d1 - d2), delta_b=float(d2 - d1),
        ing_full_a=float(2 * f1 - f2), ing_full_b=float(f2 - f1),
        egress_a=eg_a, egress_b=eg_b,
        temporal_steps=int(t_steps),
        noc_latency=noc_latency,
    )
