"""Batched twin of the faithful engine.

The paper's DSE sweeps hardware parameters (#PEs, NoC bandwidth) holding
(layer × dataflow) fixed.  Because the analysis in ``model.py`` is written
against the backend facade, the *same code* runs with the hardware
parameters as (n,)-shaped tensors: layer dims, directive sizes, temporal
trip counts and the iteration-case structure stay static Python ints
(hybrid backend), while everything touched by ``num_pes`` / ``noc_bw`` is a
tensor op over the whole batch.  No ``vmap`` is needed: one pass of the
analysis evaluates every design point of the batch.

Output is a flat, fixed-shape feature vector per design point so the DSE
can stack millions of them.  Dtypes follow the reference with x64 off:
``num_pes`` int32, ``noc_bw`` and the features float32.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping

import torch

from ..devices import resolve_device
from .cluster_analysis import build_dense_level, hybrid_backend
from .directives import Cluster, Dataflow
from .model import (analyze, analyze_dense_level, assemble_stats,
                    blend_level_results)
from .performance import HWConfig
from .tensor_analysis import LayerOp

# Feature vector layout produced by the batched evaluator.
FEATURES = ("runtime", "energy_pj", "macs", "l1_kb", "l2_kb", "util",
            "bw_req", "throughput", "edp")


def _col(v, n: int, device) -> torch.Tensor:
    """One feature as float32[n]: tensors are cast, static values (Python
    numbers the hardware parameters never touched) broadcast."""
    return torch.as_tensor(v, dtype=torch.float32, device=device).expand(n)


def _features(s, n: int, device) -> torch.Tensor:
    """Pack a Stats object into the fixed FEATURES columns -> float32[n, F]."""
    runtime = _col(s.runtime, n, device)
    energy = _col(s.energy_pj, n, device)
    macs = _col(s.total_macs, n, device)
    return torch.stack([
        runtime,
        energy,
        macs,
        _col(s.l1_req_kb, n, device),
        _col(s.l2_req_kb, n, device),
        _col(s.utilization, n, device),
        _col(s.peak_bw.get(0, 0), n, device),
        macs / runtime,
        energy * runtime,
    ], dim=-1)


def stats_vector(op: LayerOp, df: Dataflow, hw: HWConfig) -> torch.Tensor:
    """A batch of design points (``hw.num_pes`` int32[n], ``hw.noc_bw``
    float32[n]) -> float32[n, F]."""
    xp = hybrid_backend()
    n = hw.num_pes.shape[0]
    return _features(analyze(op, df, hw, xp=xp), n, hw.num_pes.device)


def batched_evaluator(op: LayerOp, df: Dataflow, *, multicast: bool = True,
                      spatial_reduction: bool = True,
                      noc_latency: float = 2.0, macs_per_pe: int = 1,
                      device: str | torch.device | None = None) -> Callable:
    """Returns ``f(num_pes[i], noc_bw[i]) -> features[i, F]`` on ``device``
    (``cuda`` unless the caller asks for another).

    The returned callable evaluates the full MAESTRO analysis for every
    design point of its batch; inputs are moved to ``device`` as int32 /
    float32."""
    dev = resolve_device(device)

    def eval_batch(num_pes, noc_bw) -> torch.Tensor:
        hw = HWConfig(
            num_pes=torch.as_tensor(num_pes, dtype=torch.int32,
                                    device=dev).reshape(-1),
            noc_bw=torch.as_tensor(noc_bw, dtype=torch.float32,
                                   device=dev).reshape(-1),
            noc_latency=noc_latency, multicast=multicast,
            spatial_reduction=spatial_reduction, macs_per_pe=macs_per_pe)
        return stats_vector(op, df, hw)

    return eval_batch


@dataclasses.dataclass
class BatchStats:
    """Columnar stats for a batch of design points."""
    runtime: Any
    energy_pj: Any
    macs: Any
    l1_kb: Any
    l2_kb: Any
    util: Any
    bw_req: Any
    throughput: Any
    edp: Any

    @classmethod
    def from_features(cls, feats) -> "BatchStats":
        cols = {name: feats[..., i] for i, name in enumerate(FEATURES)}
        return cls(**{
            "runtime": cols["runtime"], "energy_pj": cols["energy_pj"],
            "macs": cols["macs"], "l1_kb": cols["l1_kb"],
            "l2_kb": cols["l2_kb"], "util": cols["util"],
            "bw_req": cols["bw_req"], "throughput": cols["throughput"],
            "edp": cols["edp"]})


def evaluate_grid(op: LayerOp, df: Dataflow, num_pes, noc_bw,
                  **kw) -> BatchStats:
    """Evaluate (layer × dataflow) over arrays of hardware design points."""
    f = batched_evaluator(op, df, **kw)
    return BatchStats.from_features(f(num_pes, noc_bw))


# ----------------------------------------------------------------------
# Tile-size twin: the mapping-space axis (repro_torch.mapspace)
# ----------------------------------------------------------------------
#
# The hardware DSE above holds the dataflow fixed and batches (num_pes,
# noc_bw).  The mapping search needs the dual: hardware fixed, *tile sizes*
# batched, so thousands of candidate mappings that share one directive
# structure (same dims, order, spatial choice, cluster nesting) run through
# one pass of the analysis.  Trip counts, iteration-case occurrences and
# tile volumes all become (n,)-shaped tensors; the case *structure* stays
# static per template, which is what the mapspace engine groups by.
#
# Sizes are float32, as in the reference: volume products reach ~1e10 on
# real layers, which would overflow int32.  Small-integer phase arithmetic
# (trip counts, equality tests) stays exact in float32 far beyond any
# realistic dim extent (< 2^24).

def batched_tile_evaluator(op: LayerOp, template: Dataflow,
                           var_slots: tuple[int, ...], *,
                           num_pes: int, noc_bw: float,
                           multicast: bool = True,
                           spatial_reduction: bool = True,
                           noc_latency: float = 2.0,
                           macs_per_pe: int = 1,
                           device: str | torch.device | None = None
                           ) -> Callable:
    """Returns ``f(sizes[i, S], offsets[i, S]) -> features[i, F]`` on
    ``device`` (``cuda`` unless the caller asks for another).

    ``template`` is a structurally-complete directive program whose
    directives at positions ``var_slots`` have placeholder size/offset; the
    evaluator substitutes column ``j`` of the operand arrays for slot ``j``
    (a ``Cluster`` slot consumes only its size column).  Hardware parameters
    are static Python numbers, as in the reference's executable."""
    dev = resolve_device(device)
    hw = HWConfig(num_pes=int(num_pes), noc_bw=float(noc_bw),
                  noc_latency=noc_latency, multicast=multicast,
                  spatial_reduction=spatial_reduction,
                  macs_per_pe=macs_per_pe)

    def eval_batch(sizes, offsets) -> torch.Tensor:
        sizes = torch.as_tensor(sizes, device=dev).to(torch.float32)
        offsets = torch.as_tensor(offsets, device=dev).to(torch.float32)
        dirs = list(template.directives)
        for j, slot in enumerate(var_slots):
            d = dirs[slot]
            if isinstance(d, Cluster):
                dirs[slot] = Cluster(sizes[:, j])
            else:
                dirs[slot] = type(d)(sizes[:, j], offsets[:, j], d.dim)
        df = Dataflow(template.name, tuple(dirs))
        with torch.inference_mode():
            return _features(analyze(op, df, hw, xp=hybrid_backend()),
                             sizes.shape[0], dev)

    return eval_batch


# ----------------------------------------------------------------------
# Universal structure-as-operand evaluator: the whole mapping space of an
# (op × level-count) family through one evaluator
# ----------------------------------------------------------------------
#
# The tile twin above still needs one evaluator per (spatial × perm ×
# cluster) structure group, because loop order and spatial choice are
# Python-level structure of the directive program.  The universal
# evaluator moves that structure into operands too:
#
#   * the loop permutation is a *rank vector* (per searched axis, its
#     position in the data-movement order) — "innermost coupled loop" and
#     "advancing loop" become one-hot gathers over ranks;
#   * the spatial-dim choice is a *one-hot selector* blending each axis's
#     temporal and spatial phase quantities;
#   * the cluster option is a cluster size column plus a one-hot over the
#     space's (inner dim, inner map) candidates;
#   * hardware (#PEs, NoC bandwidth) are columns too, so a joint mapping ×
#     hardware frontier runs through the same evaluator.
#
# Per-dim quantities are computed densely over the op's full dim universe
# (unused dims are trip-count-1 loops, exactly like ``complete()``).  Where
# the reference vmaps a one-row function, the port runs the same function
# once on (n,)-shaped operand columns.

@dataclasses.dataclass(frozen=True)
class UniversalSpec:
    """Static structure of one universal evaluator: everything that is
    *not* an operand.  ``cluster`` lists the (inner_dim, inner_size,
    inner_offset) candidates of the 2-level family; empty = 1 level."""
    dim_names: tuple[str, ...]
    axis_dims: tuple[str, ...]
    pinned: tuple[str, ...]
    cluster: tuple[tuple[str, int, int], ...] = ()
    # divisor-tiled spaces: only the spatial axis can produce a non-empty
    # edge phase, so case enumeration shrinks from 2^A to A+1
    single_edge: bool = False
    # layer shape as operand (repro_torch.netspace): dim extents come from
    # an ``ext`` (i, D) operand instead of ``op.dims``, and the cluster
    # candidates' inner size/offset from ``cin_size``/``cin_off`` (i, K)
    # operands — so ONE evaluator per op-class covers every layer shape of
    # a network (the ``cluster`` entries then carry only the inner-dim
    # identity; their static size/offset fields are ignored)
    ext_operand: bool = False

    @property
    def n_levels(self) -> int:
        return 2 if self.cluster else 1


def _universal_eval(op: LayerOp, spec: UniversalSpec, hw_static: dict
                    ) -> Callable:
    """The batch evaluator closed over static structure: ``ops`` maps each
    operand name to an (n,) or (n, k) tensor; the result is float32[n, F].
    The reference's ``_universal_eval_one`` on one row, run on columns."""
    axis_dims = spec.axis_dims
    a = len(axis_dims)
    missing = [d for d in spec.dim_names
               if d not in axis_dims and d not in spec.pinned]

    def eval_batch(ops: Mapping[str, torch.Tensor]) -> torch.Tensor:
        xp = hybrid_backend()
        n = ops["pes"].shape[0]
        hw = HWConfig(num_pes=ops["pes"], noc_bw=ops["bw"], **hw_static)
        if spec.ext_operand:
            ext0 = {d: ops["ext"][:, j]
                    for j, d in enumerate(spec.dim_names)}
        else:
            ext0 = {d: op.dims[d] for d in spec.dim_names}
        sizes: dict = dict(ext0)   # non-searched dims: fully unrolled
        offsets: dict = dict(ext0)
        rank: dict = {}
        sp: dict = {d: 0 for d in spec.dim_names}
        for j, d in enumerate(axis_dims):
            sizes[d] = ops["sizes"][:, j]
            offsets[d] = ops["offsets"][:, j]
            rank[d] = ops["rank"][:, j]
            sp[d] = ops["sp"][:, j]
        # loop order mirrors the grouped templates: implicit (missing) dims
        # outermost, searched axes in permutation order, pinned window dims
        # innermost.  Trip-count-1 loops only need order-consistent ranks.
        for i, d in enumerate(missing):
            rank[d] = -1 - i
        for j, d in enumerate(spec.pinned):
            rank[d] = a + j

        pes = xp.maximum(ops["pes"], 1)
        if spec.cluster:
            c_eff = xp.maximum(xp.minimum(ops["csize"], pes), 1)
            top_units = xp.maximum(xp.floordiv(pes, c_eff), 1)
        else:
            c_eff = None
            top_units = pes

        level0 = build_dense_level(
            xp, op, index=0, ext=ext0, sizes=sizes, offsets=offsets,
            rank=rank, sp=sp, loop_dims=spec.dim_names,
            edge_dims=axis_dims, n_units=top_units,
            innermost=not spec.cluster, single_edge=spec.single_edge)

        if spec.cluster:
            def child_fn(m_unit):
                results = []
                for ki, (cd, csz, coff) in enumerate(spec.cluster):
                    if spec.ext_operand:
                        csz = ops["cin_size"][:, ki]
                        coff = ops["cin_off"][:, ki]
                    lvl1 = build_dense_level(
                        xp, op, index=1, ext=m_unit, sizes={cd: csz},
                        offsets={cd: coff}, rank={cd: 0}, sp={cd: 1},
                        loop_dims=(cd,), edge_dims=(cd,), n_units=c_eff,
                        innermost=True)
                    results.append(
                        analyze_dense_level(op, lvl1, xp, hw))
                if len(results) == 1:
                    return results[0]
                sel = [ops["csel"][:, ki] for ki in range(len(results))]
                return blend_level_results(xp, sel, results)
            top = analyze_dense_level(op, level0, xp, hw,
                                      child_fn=child_fn)
        else:
            top = analyze_dense_level(op, level0, xp, hw)
        return _features(assemble_stats(op, top, spec.n_levels, hw, xp), n,
                         ops["pes"].device)

    return eval_batch


# ----------------------------------------------------------------------
# Fused reduction tail: top-k + Pareto on the device
# ----------------------------------------------------------------------
#
# The universal evaluator returns the full (n, F) feature matrix, which
# makes the *host* the bottleneck of a large DSE: every chunk copies n x F
# floats back and the objective/top-k/Pareto reduction runs in numpy.  The
# reduced evaluator runs that reduction on the device, after the analysis:
# each chunk returns the objective column (optional), the k winner rows,
# and a within-chunk Pareto-candidate mask over (energy, throughput).  An
# optional hardware tail folds the co-DSE's area/power/leakage accounting
# (``core.dse.run_dse`` semantics) in as well.

@dataclasses.dataclass(frozen=True)
class HWTail:
    """Static hardware-accounting tail (mirrors ``core.dse.run_dse``):
    SRAM = l1*pes + l2, area/power from the RTL-regression model, leakage
    energy added to the energy/EDP columns, budget-invalid designs masked
    out of the objective and the frontier."""
    area_power: Any               # energy.AreaPowerModel (frozen, hashable)
    area_budget_mm2: float
    power_budget_mw: float


@dataclasses.dataclass(frozen=True)
class ReduceSpec:
    """Static reduction structure: objective column (canonical minimize),
    top-k width, and optional extras."""
    objective: str                # FEATURES name
    maximize: bool = False
    k: int = 8
    return_vals: bool = True      # per-row objective column
    pareto: bool = True           # (energy, throughput) candidate mask
    hw: HWTail | None = None
    cols: tuple[str, ...] = ()    # extra per-row FEATURES columns to ship
    #                               back (a network composer needs the
    #                               (runtime, energy, l1, l2) of every
    #                               candidate, not just the top-k rows)


def _set_col(feats: torch.Tensor, i: int, col: torch.Tensor) -> torch.Tensor:
    """``feats.at[:, i].set(col)``: a new matrix, the input untouched."""
    return torch.cat([feats[:, :i], col[:, None], feats[:, i + 1:]], dim=1)


def _reduce_tail(reduce: ReduceSpec, feats: torch.Tensor,
                 ops: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The reduction on (block, F) features of one shard."""
    inf = torch.tensor(float("inf"), dtype=torch.float32,
                       device=feats.device)
    live = ops["live"] > 0                       # padding rows never win
    obj_i = FEATURES.index(reduce.objective)
    runtime = feats[:, FEATURES.index("runtime")]
    valid = live
    if reduce.hw is not None:
        ap = reduce.hw.area_power
        pes, bw = ops["pes"], ops["bw"]
        l1 = feats[:, FEATURES.index("l1_kb")]
        l2 = feats[:, FEATURES.index("l2_kb")]
        sram_kb = l1 * pes + l2
        area = ap.area(pes, sram_kb, bw)
        power = ap.power(pes, sram_kb, bw)
        valid = live & (area <= reduce.hw.area_budget_mm2) \
            & (power <= reduce.hw.power_budget_mw)
        energy = feats[:, FEATURES.index("energy_pj")] \
            + ap.static_energy_pj(area, runtime)
        feats = _set_col(feats, FEATURES.index("energy_pj"), energy)
        feats = _set_col(feats, FEATURES.index("edp"), energy * runtime)
    obj = feats[:, obj_i]
    if reduce.maximize:
        obj = -obj
    obj = torch.where(torch.isfinite(obj) & valid, obj, inf)
    k = min(reduce.k, feats.shape[0])
    # lax.top_k is tie-stable (the lower index first), and the cross-shard
    # merge relies on that for 1-vs-N-device determinism: a stable
    # ascending sort gives the same k rows in the same order
    top_vals, order = torch.sort(obj, stable=True)
    top_idx = order[:k]
    out = {
        "top_vals": top_vals[:k],
        "top_idx": top_idx,
        "top_feats": feats[top_idx],
        "n_valid": valid.sum(),
    }
    if reduce.return_vals:
        out["vals"] = obj
    if reduce.cols:
        out["cols"] = feats[:, [FEATURES.index(c) for c in reduce.cols]]
    if reduce.pareto:
        e = feats[:, FEATURES.index("energy_pj")]
        t = feats[:, FEATURES.index("throughput")]
        e = torch.where(valid & torch.isfinite(e), e, inf)
        t = torch.where(valid & torch.isfinite(t), t, -inf)
        # sort-based frontier: O(n log n), not O(n^2) pairwise
        order = torch.argsort(e, stable=True)
        ts = t[order]
        prev = torch.cat([-inf[None], torch.cummax(ts, 0).values[:-1]])
        mask = torch.zeros(e.shape, dtype=torch.bool, device=e.device)
        mask = mask.index_put((order,), ts > prev)
        out["pareto_mask"] = mask & valid
        out["pareto_energy"] = e
        out["pareto_thr"] = t
    return out


def universal_reduced_evaluator(op: LayerOp, spec: UniversalSpec,
                                reduce: ReduceSpec, *,
                                multicast: bool = True,
                                spatial_reduction: bool = True,
                                noc_latency: float = 2.0,
                                macs_per_pe: int = 1) -> Callable:
    """Returns the evaluate-and-reduce function ``f(ops) -> dict``.

    Input is the universal operand dict (tensors, all on one device) plus
    a ``live`` (i,) float mask (0 = padding row); it runs where its
    operands lie.  The reference's ``n_devices`` (a pmap over a leading
    device axis) is the caller's business here: ``mapspace.universal``
    calls ``f`` once per device on that device's shard and merges the
    per-shard top-k / frontier candidates by (value, global index), which
    is deterministic for any device count.  Output per shard:

    ``top_vals``/``top_idx``/``top_feats``
        the k best rows by the canonicalized (minimized) objective;
    ``vals`` (optional)
        the full objective column — one scalar per design, NOT the
        (n, F) feature matrix;
    ``pareto_mask``/``pareto_energy``/``pareto_thr`` (optional)
        within-shard Pareto-candidate mask over (energy min, throughput
        max) plus the two columns for host-side frontier refinement;
    ``n_valid``
        count of live (and, with a hardware tail, budget-valid) rows."""
    hw_static = dict(noc_latency=noc_latency, multicast=multicast,
                     spatial_reduction=spatial_reduction,
                     macs_per_pe=macs_per_pe)
    eval_batch = _universal_eval(op, spec, hw_static)

    def chunk_fn(ops: Mapping[str, torch.Tensor]) -> dict:
        with torch.inference_mode():
            feats = eval_batch({k: v for k, v in ops.items()
                                if k != "live"})
            return _reduce_tail(reduce, feats, ops)

    return chunk_fn


def universal_evaluator(op: LayerOp, spec: UniversalSpec, *,
                        multicast: bool = True,
                        spatial_reduction: bool = True,
                        noc_latency: float = 2.0,
                        macs_per_pe: int = 1) -> Callable:
    """Returns ``f(ops) -> features[i, F]`` where ``ops`` is a dict of
    per-row operand tensors (all on one device, where ``f`` runs) encoding
    the ENTIRE mapping plus the hardware point:

    ``sizes``/``offsets`` (i, A)
        tile sizes / offsets per searched axis, canonical axis order;
    ``rank`` (i, A)
        each axis's position in the loop order (0 = outermost searched);
    ``sp`` (i, A)
        one-hot spatial-axis selector;
    ``csize`` (i,), ``csel`` (i, K)
        cluster size and one-hot over ``spec.cluster`` candidates
        (2-level specs only);
    ``ext`` (i, D), ``cin_size``/``cin_off`` (i, K)
        the layer's dim extents and resolved cluster inner maps
        (``spec.ext_operand`` only: one evaluator per op-class);
    ``pes``/``bw`` (i,)
        hardware design point per row (joint mapping × hardware search).

    One evaluator per (op, level-count): every structure group of the
    mapping space is an operand pattern of the same function.  See
    ``repro_torch.mapspace.universal`` for the MapSpace-point encoder."""
    hw_static = dict(noc_latency=noc_latency, multicast=multicast,
                     spatial_reduction=spatial_reduction,
                     macs_per_pe=macs_per_pe)
    eval_batch = _universal_eval(op, spec, hw_static)

    def run(ops: Mapping[str, torch.Tensor]) -> torch.Tensor:
        with torch.inference_mode():
            return eval_batch(ops)

    return run
