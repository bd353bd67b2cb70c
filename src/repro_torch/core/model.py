"""MAESTRO's combined performance + cost analysis (paper Fig. 7/8).

``analyze(op, dataflow, hw)`` runs the recursive multi-cluster analysis:

  * the CLA engine instantiates cluster levels and iteration phases;
  * the RA engine supplies per-level reuse classes, traffic totals, and
    steady-state per-step deltas;
  * the PA engine turns volumes into pipe-model delays; the steady-state
    step delay is ``max(ingress, compute, egress)`` (double buffering), the
    first iteration is serial (the Fig. 8 ``IsFullInit`` special case);
  * the CA engine accumulates buffer access counts, buffer size
    requirements, and energy.

The outstanding delay of an inner cluster level is the compute delay of the
level above (paper §4.4), implemented by recursion with memoization over the
per-case tile sizes.  All math flows through the :class:`Backend` facade, so
the faithful integer engine and the tensor-valued DSE twin share this file.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import torch

from .cluster_analysis import (Backend, DenseLevel, LevelSpec, LoopInfo,
                               enumerate_cases, enumerate_cases_dense,
                               py_backend, spatial_phases, temporal_phases,
                               unit_counts)
from .directives import (FULL, Dataflow, MapDirective, SpatialMap, complete,
                         extended_dims, is_static_size)
from .energy import DEFAULT_ENERGY, EnergyModel
from .performance import (HWConfig, comm_delay, compute_delay, log2_ceil,
                          reduction_fwd_delay)
from .reuse_analysis import (OUTPUT, TensorReuse, analyze_level_traffic,
                             analyze_level_traffic_dense, classify_level,
                             dense_level_tile_sizes, psums_volume,
                             spatial_reduction_active,
                             spatial_reduction_indicator, tensor_volume,
                             level_tile_sizes)
from .tensor_analysis import LayerOp


# ----------------------------------------------------------------------

@dataclasses.dataclass
class LevelResult:
    """Analysis of ONE execution of a cluster level (one parent step)."""
    runtime: Any
    macs: Any
    counts: dict[tuple[int, str, str], Any]
    buf_req: dict[tuple[int, str], Any]       # (tier, tensor) -> elements
    peak_bw: dict[int, Any]                   # tier -> elements/cycle
    active_pe_steps: Any
    total_pe_steps: Any
    reuse: dict[int, dict[str, TensorReuse]]  # level -> tensor -> classes


@dataclasses.dataclass
class Stats:
    """End-to-end estimates for (layer × dataflow × hardware)."""
    runtime: Any                       # cycles
    total_macs: Any
    throughput: Any                    # MACs/cycle
    utilization: Any                   # fraction of PE-steps active
    counts: dict[tuple[int, str, str], Any]
    buf_req: dict[tuple[int, str], Any]
    l1_req_kb: Any
    l2_req_kb: Any
    peak_bw: dict[int, Any]            # NoC bw requirement per tier
    energy_pj: Any
    energy_breakdown: dict[str, Any]
    reuse: dict[int, dict[str, TensorReuse]]
    reuse_factor: dict[str, Any]       # L1 accesses per L2 fetch per tensor
    num_levels: int

    @property
    def edp(self) -> Any:
        return self.energy_pj * self.runtime


# ----------------------------------------------------------------------

def _build_level(xp: Backend, maps: tuple[MapDirective, ...],
                 dims: dict[str, Any], n_units: Any, index: int,
                 innermost: bool, op: LayerOp) -> LevelSpec:
    # Aligned spatial (outer, window) pairs — e.g. Eyeriss's Y/R diagonal —
    # traverse *within* a window, so their offsets are not stride-scaled.
    spatial_dims = {d.dim for d in maps if isinstance(d, SpatialMap)}
    aligned: set[str] = set()
    for e in op.output.entries:
        from .tensor_analysis import ConvExpr as _CE
        if isinstance(e, _CE) and e.outer in spatial_dims \
                and e.window in spatial_dims:
            aligned.add(e.outer)
    loops: list[LoopInfo] = []
    for d in maps:
        D = dims[d.dim]
        # FULL survives resolve() only for static programs; traced sizes
        # (mapspace vectorization) can never be the sentinel.
        size = D if is_static_size(d.size) and d.size == FULL else d.size
        offset = D if is_static_size(d.offset) and d.offset == FULL \
            else d.offset
        if d.dim not in aligned:
            offset = offset * op.stride_of(d.dim)  # CLA stride handling
        if isinstance(d, SpatialMap):
            st, ed = spatial_phases(xp, D, size, offset, n_units)
            loops.append(LoopInfo(
                dataclasses.replace(d, size=size, offset=offset),
                d.dim, True, n_units, st, ed))
        else:
            st, ed = temporal_phases(xp, D, size, offset)
            loops.append(LoopInfo(
                dataclasses.replace(d, size=size, offset=offset),
                d.dim, False, 1, st, ed))
    return LevelSpec(index=index, loops=tuple(loops), n_units=n_units,
                     dims=dict(dims), is_innermost=innermost)


def _dims_key(dims: dict[str, Any]) -> tuple | None:
    # tensor values (even one-element ones) disable memoization
    if any(isinstance(v, torch.Tensor) for v in dims.values()):
        return None
    return tuple(sorted((k, int(v)) for k, v in dims.items()))


def _analyze_level(op: LayerOp, level_maps, counts_units, li: int,
                   dims: dict[str, Any], xp: Backend, hw: HWConfig,
                   cache: dict) -> LevelResult:
    key = (li, _dims_key(dims))
    if key[1] is not None and key in cache:
        return cache[key]

    innermost = li == len(level_maps) - 1
    level = _build_level(xp, level_maps[li], dims, counts_units[li], li,
                         innermost, op)
    traffic = analyze_level_traffic(op, level, xp, hw.multicast,
                                    hw.spatial_reduction)
    cases = enumerate_cases(level, xp)
    has_spatial_reduction = spatial_reduction_active(op, level)

    counts: dict[tuple[int, str, str], Any] = {}
    buf_req: dict[tuple[int, str], Any] = {}
    peak_bw: dict[int, Any] = {}
    reuse_all: dict[int, dict[str, TensorReuse]] = {li: traffic.reuse}

    def bump(k, v):
        counts[k] = counts.get(k, 0) + v

    def req(k, v):
        prev = buf_req.get(k, 0)
        buf_req[k] = xp.maximum(prev, v)

    # ---- steady-state delays (per step) -------------------------------
    delta_total = 0
    for t in op.input_tensors():
        delta_total = delta_total + traffic.step_delta[t.name]
    ingress_sd = comm_delay(xp, delta_total, hw)
    egress_sd = comm_delay(xp, traffic.step_egress, hw)
    fwd = reduction_fwd_delay(xp, level.n_units, hw, has_spatial_reduction)

    # ---- per-case compute + accumulation ------------------------------
    runtime = 0
    macs = 0
    active_pe_steps = 0
    total_pe_steps = 0
    steady_compute = None

    for case in cases:
        occ = case.occurrences
        if isinstance(occ, int) and occ == 0:
            continue
        m_unit = case.sizes
        if innermost:
            psums = psums_volume(op, m_unit, xp)
            comp = compute_delay(xp, psums, hw)
            child_macs = psums
            child_active, child_total = 1, 1
            child_runtime = comp
        else:
            child = _analyze_level(op, level_maps, counts_units, li + 1,
                                   m_unit, xp, hw, cache)
            comp = child.runtime
            child_macs = child.macs
            child_active, child_total = (child.active_pe_steps,
                                         child.total_pe_steps)
            child_runtime = child.runtime
            for k, v in child.counts.items():
                bump(k, v * occ * case.active_units)
            for k, v in child.buf_req.items():
                req(k, v)
            for tier, bw in child.peak_bw.items():
                peak_bw[tier] = xp.maximum(peak_bw.get(tier, 0), bw)
            reuse_all.update(child.reuse)

        # trailing partially-filled unit (spatial edge folding)
        partial_macs = 0
        for sdim, psz in case.partial_unit_sizes.items():
            if isinstance(psz, int) and psz == 0:
                continue
            mp = dict(m_unit)
            mp[sdim] = psz
            partial_macs = partial_macs + psums_volume(op, mp, xp) \
                * xp.where(psz > 0, 1, 0)

        step = xp.maximum(xp.maximum(comp + fwd, ingress_sd), egress_sd)
        runtime = runtime + occ * step
        case_macs = occ * (case.active_units * child_macs + partial_macs)
        macs = macs + case_macs
        has_partial = 0
        for psz in case.partial_unit_sizes.values():
            has_partial = xp.maximum(has_partial, xp.where(psz > 0, 1, 0))
        active_pe_steps = active_pe_steps + occ * (
            case.active_units * child_active + has_partial * child_active)
        total_pe_steps = total_pe_steps + occ * level.n_units * child_total
        if steady_compute is None:
            steady_compute = comp  # first case = all-steady phases

        # per-unit buffer requirement at tier li+1 (double-buffered tile)
        unit_ws = 0
        for t in op.tensors():
            unit_ws = unit_ws + tensor_volume(t, m_unit, xp)
        req((li + 1, "ALL"), 2 * unit_ws)

    # ---- init case: first iteration is serial (no double buffering) ---
    full_ingress = 0
    tiles = level_tile_sizes(level, xp)
    for t in op.input_tensors():
        v = tensor_volume(t, tiles, xp)
        if not hw.multicast:
            v = v * traffic.multicast_factor[t.name]
        full_ingress = full_ingress + v
    ing_full_d = comm_delay(xp, full_ingress, hw)
    sc = steady_compute if steady_compute is not None else 0
    serial = ing_full_d + sc + fwd + egress_sd
    overlapped = xp.maximum(xp.maximum(sc + fwd, ingress_sd), egress_sd)
    runtime = runtime + (serial - overlapped)

    # ---- this level's own traffic counts ------------------------------
    for t in op.input_tensors():
        unique = traffic.ingress[t.name]
        delivered = unique * (traffic.multicast_factor[t.name]
                              if hw.multicast else 1)
        bump((li, t.name, "read"), unique)
        bump((li + 1, t.name, "write"), delivered)
    bump((li, OUTPUT, "read"), traffic.psum_readback)
    bump((li, OUTPUT, "write"), traffic.egress[OUTPUT])

    if innermost:
        # MAC operand accesses against the PE-local buffer (tier li+1)
        for t in op.input_tensors():
            bump((li + 1, t.name, "read"), macs)
        bump((li + 1, OUTPUT, "read"), macs)
        bump((li + 1, OUTPUT, "write"), macs)

    # upper buffer must hold the level working set, double-buffered
    lvl_ws = 0
    for t in op.tensors():
        lvl_ws = lvl_ws + tensor_volume(t, tiles, xp)
    req((li, "ALL"), 2 * lvl_ws)

    # NoC bandwidth requirement to avoid stalling compute (Fig. 11c)
    comp_floor = xp.maximum(sc, 1)
    peak_bw[li] = xp.maximum(
        peak_bw.get(li, 0),
        (delta_total + traffic.step_egress) / comp_floor)

    result = LevelResult(
        runtime=runtime, macs=macs, counts=counts, buf_req=buf_req,
        peak_bw=peak_bw, active_pe_steps=active_pe_steps,
        total_pe_steps=total_pe_steps, reuse=reuse_all)
    if key[1] is not None:
        cache[key] = result
    return result


# ----------------------------------------------------------------------
# Order-oblivious (dense) level analysis — structure as operands
# ----------------------------------------------------------------------

def analyze_dense_level(op: LayerOp, level: DenseLevel, xp: Backend,
                        hw: HWConfig, child_fn=None) -> LevelResult:
    """Dense twin of :func:`_analyze_level` for a :class:`DenseLevel` whose
    loop order / spatial choice / sizes may all be traced operands.

    ``child_fn(case_sizes) -> LevelResult`` analyzes the inner cluster
    level for one iteration case; ``None`` marks the innermost level.  The
    accumulation mirrors the faithful engine case for case (phantom cases
    with zero occurrences contribute zero-weighted terms, exactly like the
    grouped traced engine), so results are bit-equal modulo float32."""
    li = level.index
    traffic = analyze_level_traffic_dense(op, level, xp, hw.multicast,
                                          hw.spatial_reduction)
    cases = enumerate_cases_dense(level, xp, level.single_edge)
    sra = spatial_reduction_indicator(op, level, xp)

    counts: dict[tuple[int, str, str], Any] = {}
    buf_req: dict[tuple[int, str], Any] = {}
    peak_bw: dict[int, Any] = {}

    def bump(k, v):
        counts[k] = counts.get(k, 0) + v

    def req(k, v):
        prev = buf_req.get(k, 0)
        buf_req[k] = xp.maximum(prev, v)

    # ---- steady-state delays (per step) -------------------------------
    delta_total = 0
    for t in op.input_tensors():
        delta_total = delta_total + traffic.step_delta[t.name]
    ingress_sd = comm_delay(xp, delta_total, hw)
    egress_sd = comm_delay(xp, traffic.step_egress, hw)
    fwd = sra * log2_ceil(xp, level.n_units)

    # ---- per-case compute + accumulation ------------------------------
    runtime = 0
    macs = 0
    active_pe_steps = 0
    total_pe_steps = 0
    steady_compute = None

    for case in cases:
        occ = case.occurrences
        m_unit = case.sizes
        if child_fn is None:
            psums = psums_volume(op, m_unit, xp)
            comp = compute_delay(xp, psums, hw)
            child_macs = psums
            child_active, child_total = 1, 1
        else:
            child = child_fn(m_unit)
            comp = child.runtime
            child_macs = child.macs
            child_active, child_total = (child.active_pe_steps,
                                         child.total_pe_steps)
            for k, v in child.counts.items():
                bump(k, v * occ * case.active_units)
            for k, v in child.buf_req.items():
                req(k, v)
            for tier, bw in child.peak_bw.items():
                peak_bw[tier] = xp.maximum(peak_bw.get(tier, 0), bw)

        # trailing partially-filled unit: only the spatial dim carries a
        # non-zero (one-hot-blended) partial, so one override suffices
        p_total = 0
        mp = dict(m_unit)
        for d, psz in case.partial_unit_sizes.items():
            p_total = p_total + psz
            mp[d] = (1 - level.sp.get(d, 0)) * m_unit[d] + psz
        has_partial = xp.where(p_total > 0, 1, 0)
        partial_macs = psums_volume(op, mp, xp) * has_partial

        step = xp.maximum(xp.maximum(comp + fwd, ingress_sd), egress_sd)
        runtime = runtime + occ * step
        macs = macs + occ * (case.active_units * child_macs + partial_macs)
        active_pe_steps = active_pe_steps + occ * (
            case.active_units * child_active + has_partial * child_active)
        total_pe_steps = total_pe_steps + occ * level.n_units * child_total
        if steady_compute is None:
            steady_compute = comp  # first case = all-steady phases

        unit_ws = 0
        for t in op.tensors():
            unit_ws = unit_ws + tensor_volume(t, m_unit, xp)
        req((li + 1, "ALL"), 2 * unit_ws)

    # ---- init case: first iteration is serial (no double buffering) ---
    full_ingress = 0
    tiles = dense_level_tile_sizes(level, xp)
    for t in op.input_tensors():
        v = tensor_volume(t, tiles, xp)
        if not hw.multicast:
            v = v * traffic.multicast_factor[t.name]
        full_ingress = full_ingress + v
    ing_full_d = comm_delay(xp, full_ingress, hw)
    sc = steady_compute if steady_compute is not None else 0
    serial = ing_full_d + sc + fwd + egress_sd
    overlapped = xp.maximum(xp.maximum(sc + fwd, ingress_sd), egress_sd)
    runtime = runtime + (serial - overlapped)

    # ---- this level's own traffic counts ------------------------------
    for t in op.input_tensors():
        unique = traffic.ingress[t.name]
        delivered = unique * (traffic.multicast_factor[t.name]
                              if hw.multicast else 1)
        bump((li, t.name, "read"), unique)
        bump((li + 1, t.name, "write"), delivered)
    bump((li, OUTPUT, "read"), traffic.psum_readback)
    bump((li, OUTPUT, "write"), traffic.egress[OUTPUT])

    if child_fn is None:
        for t in op.input_tensors():
            bump((li + 1, t.name, "read"), macs)
        bump((li + 1, OUTPUT, "read"), macs)
        bump((li + 1, OUTPUT, "write"), macs)

    lvl_ws = 0
    for t in op.tensors():
        lvl_ws = lvl_ws + tensor_volume(t, tiles, xp)
    req((li, "ALL"), 2 * lvl_ws)

    comp_floor = xp.maximum(sc, 1)
    peak_bw[li] = xp.maximum(
        peak_bw.get(li, 0),
        (delta_total + traffic.step_egress) / comp_floor)

    return LevelResult(
        runtime=runtime, macs=macs, counts=counts, buf_req=buf_req,
        peak_bw=peak_bw, active_pe_steps=active_pe_steps,
        total_pe_steps=total_pe_steps, reuse={li: {}})


def blend_level_results(xp: Backend, sel: Sequence[Any],
                        results: Sequence[LevelResult]) -> LevelResult:
    """One-hot blend of per-candidate :class:`LevelResult` objects (the
    cluster inner-dim selector of the universal evaluator).  All candidates
    share the same static key structure."""
    def scalar(vals):
        out = 0
        for s, v in zip(sel, vals):
            out = out + s * v
        return out

    def dicts(ds):
        # first-appearance key order, NOT a set: set iteration is
        # PYTHONHASHSEED-ordered, which would reorder the traced blend
        # sums and make cross-process results differ at the ulp level
        keys: dict[Any, None] = {}
        for d in ds:
            for k in d:
                keys.setdefault(k)
        return {k: scalar([d.get(k, 0) for d in ds]) for k in keys}

    return LevelResult(
        runtime=scalar([r.runtime for r in results]),
        macs=scalar([r.macs for r in results]),
        counts=dicts([r.counts for r in results]),
        buf_req=dicts([r.buf_req for r in results]),
        peak_bw=dicts([r.peak_bw for r in results]),
        active_pe_steps=scalar([r.active_pe_steps for r in results]),
        total_pe_steps=scalar([r.total_pe_steps for r in results]),
        reuse={})


# ----------------------------------------------------------------------

def analyze(op: LayerOp, df: Dataflow, hw: HWConfig,
            xp: Backend | None = None,
            energy_model: EnergyModel = DEFAULT_ENERGY) -> Stats:
    """Run MAESTRO's full analysis for one layer."""
    xp = xp or py_backend()
    cdf = complete(df, op.dims)
    level_maps = cdf.levels
    counts_units = unit_counts(xp, hw.num_pes, cdf.cluster_sizes)
    cache: dict = {}
    top = _analyze_level(op, level_maps, counts_units, 0,
                         extended_dims(df, op.dims), xp, hw, cache)
    return assemble_stats(op, top, len(level_maps), hw, xp, energy_model)


def assemble_stats(op: LayerOp, top: LevelResult, n_levels: int,
                   hw: HWConfig, xp: Backend,
                   energy_model: EnergyModel = DEFAULT_ENERGY) -> Stats:
    """Turn a top-level :class:`LevelResult` into end-to-end :class:`Stats`
    (buffer sizing, CACTI-style energy, utilization, reuse factors).

    Shared by the faithful/grouped engines (via :func:`analyze`) and the
    universal structure-as-operand evaluator, which builds the top
    ``LevelResult`` densely with mapping structure as traced operands."""
    em = energy_model
    bytes_ = hw.dtype_bytes
    l1_req = top.buf_req.get((n_levels, "ALL"), 0)
    l2_req = top.buf_req.get((0, "ALL"), 0)
    l1_kb = l1_req * bytes_ / 1024.0
    l2_kb = l2_req * bytes_ / 1024.0
    # CACTI-style sqrt-capacity scaling of access energy with the buffers
    # MAESTRO reports for this dataflow (paper §5: "the DSE tool places the
    # exact amount buffers MAESTRO reported").
    l1s, l2s = em.l1_scale(l1_kb), em.l2_scale(l2_kb)
    # tier 0 = global (L2); innermost tier (= n_levels) = PE-local L1;
    # intermediate tiers priced as L2-class buffers.
    e_read = {t: (em.l1_read * l1s if t == n_levels else em.l2_read * l2s)
              for t in range(n_levels + 1)}
    e_write = {t: (em.l1_write * l1s if t == n_levels else em.l2_write * l2s)
               for t in range(n_levels + 1)}

    breakdown: dict[str, Any] = {"mac": top.macs * em.mac}
    energy = breakdown["mac"]
    noc_elems = 0
    for (tier, tensor, kind), v in top.counts.items():
        label = "l1" if tier == n_levels else "l2"
        e = (e_read if kind == "read" else e_write)[tier] * v
        breakdown[label] = breakdown.get(label, 0) + e
        energy = energy + e
        if kind == "read" and tier < n_levels:
            noc_elems = noc_elems + v
    breakdown["noc"] = noc_elems * em.noc_hop
    energy = energy + breakdown["noc"]

    util = top.active_pe_steps / xp.maximum(top.total_pe_steps, 1)
    runtime = xp.maximum(top.runtime, 1)

    # reuse factor = local (L1) accesses per fetch from the top buffer
    rf: dict[str, Any] = {}
    for t in op.input_tensors():
        l1 = top.counts.get((n_levels, t.name, "read"), 0)
        l2 = top.counts.get((0, t.name, "read"), 1)
        rf[t.name] = l1 / xp.maximum(l2, 1)
    l1o = (top.counts.get((n_levels, OUTPUT, "read"), 0)
           + top.counts.get((n_levels, OUTPUT, "write"), 0))
    l2o = (top.counts.get((0, OUTPUT, "write"), 0)
           + top.counts.get((0, OUTPUT, "read"), 0))
    rf[OUTPUT] = l1o / xp.maximum(l2o, 1)

    return Stats(
        runtime=runtime,
        total_macs=top.macs,
        throughput=top.macs / runtime,
        utilization=util,
        counts=top.counts,
        buf_req=top.buf_req,
        l1_req_kb=l1_kb,
        l2_req_kb=l2_kb,
        peak_bw=top.peak_bw,
        energy_pj=energy,
        energy_breakdown=breakdown,
        reuse=top.reuse,
        reuse_factor=rf,
        num_levels=n_levels,
    )


def analyze_network(layers: list[LayerOp], df_for_layer, hw: HWConfig,
                    xp: Backend | None = None) -> dict[str, Stats]:
    """Analyze a whole DNN: ``df_for_layer(layer) -> Dataflow``. Returns
    per-layer stats; end-to-end numbers are the sums."""
    out: dict[str, Stats] = {}
    for layer in layers:
        out[layer.name] = analyze(layer, df_for_layer(layer), hw, xp)
    return out


def network_totals(stats: dict[str, Stats]) -> dict[str, Any]:
    runtime = sum(s.runtime for s in stats.values())
    energy = sum(s.energy_pj for s in stats.values())
    macs = sum(s.total_macs for s in stats.values())
    return {
        "runtime": runtime,
        "energy_pj": energy,
        "total_macs": macs,
        "throughput": macs / max(runtime, 1),
        "edp": energy * runtime,
    }
