"""Reuse analysis (RA) engine.

From the directive program and tensor coupling (TA engine), derive for every
tensor at every cluster level:

  * the *spatial* reuse class across sub-units — multicast (decoupled from
    the spatially mapped dim), halo (coupled, offset < size), unique
    (coupled, disjoint), or reduction (output decoupled from a spatially
    mapped reduction dim);
  * the *temporal* reuse class across adjacent steps — stationary (decoupled
    from the advancing dim), partial (coupled with sliding overlap), or none
    (full refetch);
  * the data volumes these imply: per-unit tiles, level-unique volumes,
    steady-state per-step deltas, and whole-level traffic totals.

The adjacent-step rule follows the paper (§4.1 RA engine): reuse is assessed
against the innermost non-fully-unrolled map directive; outer-loop advances
(rollovers) refetch whole tiles.  Totals are closed-form products over loop
trip counts, so the same code runs on ints and torch tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Sequence

from .cluster_analysis import Backend, DenseLevel, LevelSpec, LoopInfo, mix
from .tensor_analysis import (FILTER, INPUT, OUTPUT, ConvExpr, DimExpr,
                              LayerOp, TensorSpec, WindowExpr)

# Reuse classes
MULTICAST, HALO, UNIQUE, REDUCTION = "multicast", "halo", "unique", "reduction"
STATIONARY, PARTIAL, NONE = "stationary", "partial", "none"


# ----------------------------------------------------------------------
# Volume helpers
# ----------------------------------------------------------------------

def tensor_volume(t: TensorSpec, m: Mapping[str, Any], xp: Backend,
                  override: dict[str, Any] | None = None) -> Any:
    """Volume of a tensor tile under mapped sizes ``m``; ``override`` swaps
    the extent of specific dims (used for delta/halo computations)."""
    if not t.has_data:
        return 0
    mm = dict(m)
    if override:
        mm.update(override)
    v = 1
    for e in t.entries:
        v = v * _expr_extent(e, mm, xp)
    return v


def _expr_extent(e, mm, xp: Backend):
    if isinstance(e, DimExpr):
        return mm[e.name]
    if isinstance(e, WindowExpr):
        a, w = mm[e.outer], mm[e.window]
        ext = (a - 1) * e.stride + w
        both = xp.where(a > 0, 1, 0) * xp.where(w > 0, 1, 0)
        return xp.maximum(ext, 0) * both
    assert isinstance(e, ConvExpr)
    tt, w = mm[e.outer], mm[e.window]
    ext = xp.maximum((tt - w), 0)
    return xp.floordiv(ext, e.stride) + xp.where(tt >= w, 1, 0)


def psums_volume(op: LayerOp, m: Mapping[str, Any], xp: Backend) -> Any:
    v = 1
    for e in op.iter_entries:
        v = v * _expr_extent(e, m, xp)
    return v


# ----------------------------------------------------------------------
# Classification (Table 1 reproduction)
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TensorReuse:
    tensor: str
    spatial: str
    temporal: str


def advancing_loop(level: LevelSpec) -> LoopInfo | None:
    """The innermost *temporal* map directive that actually iterates — the
    dim whose advance defines adjacent-step reuse (paper RA engine).

    Spatial folding is excluded on purpose: fold trip counts depend on the
    (possibly traced) PE count, and fold refetches are already captured by
    the closed-form traffic totals.  Restricting the steady-state delta to
    temporal advances keeps the faithful and vectorized engines bit-equal.
    Trip counts of temporal loops are static Python ints whenever layer dims
    and directive sizes are static."""
    for lp in reversed(level.loops):
        if lp.is_spatial:
            continue
        steps = lp.total_steps()
        if not isinstance(steps, int) or steps > 1:
            return lp
    return None


def _is_advancing(level: LevelSpec, inner: LoopInfo, xp: Backend):
    """1/0 indicator that ``inner`` is this level's advancing loop — the
    innermost temporal map that actually iterates (see
    :func:`advancing_loop`).  Equivalent to ``inner is advancing_loop(level)``
    for static trip counts, but expressed through the backend facade so the
    vectorized engine (traced tile sizes) evaluates the same rule instead of
    concretizing a Python branch."""
    if inner.is_spatial:
        return 0
    ind = xp.where(inner.total_steps() > 1, 1, 0)
    for lp in reversed(level.loops):
        if lp is inner:
            break
        if not lp.is_spatial:
            ind = ind * xp.eq(lp.total_steps(), 1)
    return ind


def spatial_reduction_active(op: LayerOp, level: LevelSpec) -> bool:
    """True when sub-units produce partial sums for the *same* outputs:
    either a reduction dim (C) is spatially mapped, or an aligned pair of
    spatial maps covers both dims of one output ConvExpr (Eyeriss's Y/R
    diagonal — each unit computes the same output row)."""
    sdims = {lp.dim for lp in level.spatial_loops()}
    if sdims & op.reduction_dims():
        return True
    for e in op.output.entries:
        if isinstance(e, ConvExpr) and e.outer in sdims and e.window in sdims:
            return True
    return False


def _classification_adv(level: LevelSpec) -> LoopInfo | None:
    """Innermost loop that advances over *time* — spatial folds included
    when their trip count is statically known (classification only; the
    traffic math uses the temporal-only :func:`advancing_loop` so faithful
    and traced engines stay bit-equal)."""
    for lp in reversed(level.loops):
        steps = lp.total_steps()
        if isinstance(steps, int):
            if steps > 1:
                return lp
        elif not lp.is_spatial:
            return lp
    return None


def classify_tensor(op: LayerOp, t: TensorSpec, level: LevelSpec
                    ) -> TensorReuse:
    sps = level.spatial_loops()
    red = op.reduction_dims()
    if not sps:
        spatial = NONE
    elif t.name == OUTPUT and spatial_reduction_active(op, level):
        spatial = REDUCTION
    elif not any(t.coupled_to(sp.dim) for sp in sps):
        spatial = MULTICAST
    else:
        coupled = [sp for sp in sps if t.coupled_to(sp.dim)]
        d = coupled[0].directive
        spatial = HALO if _lt(d.offset, d.size) else UNIQUE

    adv = _classification_adv(level)
    if adv is None or not t.coupled_to(adv.dim):
        temporal = STATIONARY
    else:
        d = adv.directive
        temporal = PARTIAL if _lt(d.offset, d.size) else NONE
    return TensorReuse(t.name, spatial, temporal)


def _lt(a, b) -> bool:
    try:
        return bool(a < b)
    except Exception:
        # Traced size/offset (mapspace vectorization).  The classification is
        # reporting-only metadata — the traffic math below is closed-form and
        # never consumes it — so fall back to the disjoint-tiling class
        # rather than forcing concretization.
        return False


def classify_level(op: LayerOp, level: LevelSpec) -> dict[str, TensorReuse]:
    return {t.name: classify_tensor(op, t, level) for t in op.tensors()}


def reuse_opportunity_table(op: LayerOp) -> dict[tuple[str, str], dict]:
    """Programmatic regeneration of the paper's Table 1: for each (spatially
    mapped dim, innermost temporally mapped dim) pair, the coupling of each
    tensor and the implied reuse opportunity."""
    table = {}
    dims = [d for d in op.dims if op.dims[d] >= 1 and d != "N"]
    red = op.reduction_dims()
    for sd in dims:
        for td in dims:
            if td == sd:
                continue
            entry: dict[str, dict[str, str]] = {"spatial": {}, "temporal": {}}
            for t in op.tensors():
                if t.name == OUTPUT and sd in red:
                    entry["spatial"][t.name] = REDUCTION
                elif not t.coupled_to(sd):
                    entry["spatial"][t.name] = MULTICAST
                else:
                    entry["spatial"][t.name] = "-"
                if t.name == OUTPUT and td in red:
                    entry["temporal"][t.name] = REDUCTION
                elif not t.coupled_to(td):
                    entry["temporal"][t.name] = MULTICAST
                else:
                    entry["temporal"][t.name] = "-"
            table[(sd, td)] = entry
    return table


# ----------------------------------------------------------------------
# Traffic model
# ----------------------------------------------------------------------

@dataclasses.dataclass
class LevelTraffic:
    """Whole-level traffic (elements) between this level's upper buffer and
    its sub-units, plus steady-state per-step deltas for delay analysis."""
    # totals over the full level execution
    ingress: dict[str, Any]          # F, I (and O psum readback) from above
    egress: dict[str, Any]           # O commits (incl. partial spills)
    psum_readback: Any               # portion of O ingress that is re-read
    multicast_factor: dict[str, Any]  # destinations sharing each datum
    # steady-state per-step quantities (innermost advance)
    step_delta: dict[str, Any]       # new elements needed per steady step
    step_egress: Any                 # elements committed per steady step
    total_steps: Any
    reuse: dict[str, TensorReuse]


def _loop_trips(level: LevelSpec) -> list[Any]:
    return [lp.total_steps() for lp in level.loops]


def _tile_override(lp: LoopInfo, xp: Backend) -> dict[str, Any]:
    """Axis extent of the *new* data when loop ``lp`` advances one step."""
    d = lp.directive
    if lp.is_spatial:
        adv = lp.n_units * d.offset
        span = d.size + (lp.n_units - 1) * d.offset
        return {lp.dim: xp.minimum(adv, xp.minimum(span, level_dim(lp)))}
    return {lp.dim: xp.minimum(d.offset, lp.steady.size)}


def level_dim(lp: LoopInfo) -> Any:
    # full extent of the dim at this level is steady*count-ish; the steady
    # size is the safest clamp available without the LevelSpec.
    return lp.steady.size if not lp.is_spatial else \
        lp.steady.size + (lp.n_units - 1) * lp.directive.offset


def level_tile_sizes(level: LevelSpec, xp: Backend) -> dict[str, Any]:
    """Per-step *level* extents: per-unit steady size, except spatially
    mapped dims which span all active units (halo-aware union)."""
    m = level.steady_tile()
    for sp in level.spatial_loops():
        d = sp.directive
        span = sp.steady.size + (sp.n_units - 1) * d.offset
        m[sp.dim] = xp.minimum(span, level.dims[sp.dim])
    return m


# ----------------------------------------------------------------------
# Order-oblivious (dense) traffic model — structure as operands
# ----------------------------------------------------------------------
#
# The grouped engine above walks Python lists in directive order, so loop
# order and spatial choice are compile-time structure.  The dense twins
# below compute the same closed forms with the order as a *rank vector* and
# the spatial choice as a *one-hot*: "the innermost coupled loop" becomes a
# branch-free one-hot gather over ranks, and "is the advancing loop"
# becomes an indicator product — the permutation gathers that let one XLA
# executable cover every (perm × spatial) structure group.

def innermost_one_hot(xp: Backend, ranks: Sequence[Any]) -> list[Any]:
    """0/1 indicator per entry: 1 at the maximum rank (the innermost loop in
    data-movement order), 0 elsewhere.  Ranks must be pairwise distinct."""
    out = []
    for i, ri in enumerate(ranks):
        ind = 1
        for j, rj in enumerate(ranks):
            if j != i:
                ind = ind * xp.where(ri > rj, 1, 0)
        out.append(ind)
    return out


def advancing_indicators(xp: Backend, level: DenseLevel) -> dict[str, Any]:
    """Dense twin of :func:`_is_advancing`: per loop dim, a 0/1 indicator
    that it is the level's advancing loop — temporal, actually iterating,
    with every temporal loop inner to it sitting at one trip."""
    out: dict[str, Any] = {}
    for d in level.loop_dims:
        ind = (1 - level.sp.get(d, 0)) * xp.where(level.trips(d) > 1, 1, 0)
        for d2 in level.loop_dims:
            if d2 == d:
                continue
            outer = xp.where(level.rank[d2] < level.rank[d], 1, 0)
            one_trip = xp.eq(level.trips(d2), 1)
            term = mix(xp, level.sp.get(d2, 0), 1,
                       outer + (1 - outer) * one_trip)
            ind = ind * term
        out[d] = ind
    return out


def spatial_reduction_indicator(op: LayerOp, level: DenseLevel,
                                xp: Backend) -> Any:
    """Dense 0/1 twin of :func:`spatial_reduction_active`: a reduction dim
    is spatially mapped, or an aligned (outer, window) output pair is."""
    red = op.reduction_dims()
    s = 0
    for d in level.loop_dims:
        if d in red:
            s = s + level.sp.get(d, 0)
        for e in op.output.entries:
            if isinstance(e, ConvExpr) and e.outer == d \
                    and e.window in level.loop_dims:
                s = s + level.sp.get(d, 0) * level.sp.get(e.window, 0)
    return xp.minimum(s, 1)


def dense_level_tile_sizes(level: DenseLevel, xp: Backend
                           ) -> dict[str, Any]:
    """Dense twin of :func:`level_tile_sizes`: per-step level extents —
    steady per-unit size, except spatially mapped dims which span all
    active units (blended by the spatial one-hot)."""
    m = dict(level.ext)
    for d in level.loop_dims:
        s = level.steady[d].size
        span = s + (level.n_units - 1) * level.off_eff[d]
        m[d] = mix(xp, level.sp.get(d, 0),
                   xp.minimum(span, level.ext[d]), s)
    return m


def _dense_advance(level: DenseLevel, d: str, xp: Backend) -> Any:
    """Axis extent of the new data when loop ``d`` advances one step —
    dense twin of :func:`_tile_override` (spatial/temporal blended)."""
    s = level.steady[d].size
    o = level.off_eff[d]
    span = s + (level.n_units - 1) * o
    adv_sp = xp.minimum(level.n_units * o, span)
    adv_t = xp.minimum(o, s)
    return mix(xp, level.sp.get(d, 0), adv_sp, adv_t)


def analyze_level_traffic_dense(op: LayerOp, level: DenseLevel,
                                xp: Backend, multicast_hw: bool = True,
                                reduction_hw: bool = True) -> LevelTraffic:
    """Order-oblivious twin of :func:`analyze_level_traffic`.

    Produces bit-equal quantities for any single-spatial-map level: the
    innermost-coupled-loop choice, the advancing-loop rule and the
    psum-spill rule are all evaluated through rank/one-hot indicators
    instead of list positions, so loop order and spatial choice can be
    traced operands.  Reuse *classification* (reporting-only metadata) is
    structural and therefore omitted."""
    tiles = dense_level_tile_sizes(level, xp)
    trips = {d: level.trips(d) for d in level.loop_dims}
    total_steps = 1
    for d in level.loop_dims:
        total_steps = total_steps * trips[d]
    adv_ind = advancing_indicators(xp, level)

    ingress: dict[str, Any] = {}
    mfac: dict[str, Any] = {}
    step_delta: dict[str, Any] = {}

    for t in op.input_tensors():
        cl = [d for d in level.loop_dims if t.coupled_to(d)]
        tile = tensor_volume(t, tiles, xp)
        if not cl:
            ing = tile
            delta = 0
        else:
            inner = innermost_one_hot(xp, [level.rank[d] for d in cl])
            n_in = 0
            dvol = 0
            outer_prod = 1
            for w, d in zip(inner, cl):
                n_in = n_in + w * trips[d]
                dv = tensor_volume(t, tiles, xp,
                                   override={d: _dense_advance(level, d, xp)})
                dvol = dvol + w * xp.minimum(dv, tile)
                outer_prod = outer_prod * (1 + (1 - w) * (trips[d] - 1))
            ing = outer_prod * (tile + (n_in - 1) * dvol)
            ind = 0
            for w, d in zip(inner, cl):
                ind = ind + w * adv_ind[d]
            delta = ind * dvol + (1 - ind) * tile
        coupled_sp = 0
        for d in cl:
            coupled_sp = coupled_sp + level.sp.get(d, 0)
        mfac[t.name] = 1 + (1 - coupled_sp) * (level.n_units - 1)
        ingress[t.name] = ing
        step_delta[t.name] = delta if t.has_data else 0
        if not multicast_hw:
            ingress[t.name] = ingress[t.name] * mfac[t.name]
            step_delta[t.name] = step_delta[t.name] * mfac[t.name]

    # ---- output tensor ------------------------------------------------
    o = op.output
    o_tile = tensor_volume(o, tiles, xp)
    red_dims = op.reduction_dims()
    ocl = [d for d in level.loop_dims if o.coupled_to(d)]
    if ocl:
        commits = 1
        for d in ocl:
            commits = commits * trips[d]
        inner_o = innermost_one_hot(xp, [level.rank[d] for d in ocl])
        spill = 1
        for d in level.loop_dims:
            if d not in red_dims:
                continue
            outer = 0
            for w, di in zip(inner_o, ocl):
                outer = outer + w * xp.where(level.rank[d] < level.rank[di],
                                             1, 0)
            spill = spill * (1 + outer * (trips[d] - 1))
    else:
        commits = 1
        spill = 1
    egress_o = o_tile * commits * spill
    readback = o_tile * commits * (spill - 1)
    sra = spatial_reduction_indicator(op, level, xp)
    if not reduction_hw:
        m = 1 + sra * (level.n_units - 1)
        egress_o = egress_o * m
        readback = readback * m
    step_egress = xp.ceil_div(egress_o, xp.maximum(total_steps, 1))

    ingress[OUTPUT] = readback
    return LevelTraffic(
        ingress=ingress,
        egress={OUTPUT: egress_o},
        psum_readback=readback,
        multicast_factor=mfac,
        step_delta=step_delta,
        step_egress=step_egress,
        total_steps=total_steps,
        reuse={},
    )


def analyze_level_traffic(op: LayerOp, level: LevelSpec, xp: Backend,
                          multicast_hw: bool = True,
                          reduction_hw: bool = True) -> LevelTraffic:
    """Closed-form traffic totals for one level execution.

    For each input tensor T with coupled loops C(T) (trip counts > 1):
      ingress(T) = Π_{outer coupled} trips × [tile + (N_in − 1) × delta]
    where ``N_in`` is the innermost coupled loop's trips and ``delta`` is the
    tile volume with that loop's axis extent replaced by its advance (the
    sliding-window overlap credit).  Decoupled-from-everything tensors are
    fetched once.  Output egress multiplies the O-coupled trips and the trip
    counts of reduction loops *outer* to the innermost O-coupled loop
    (partial-sum spills; each spill is later read back)."""
    reuse = classify_level(op, level)
    loops = list(level.loops)
    tiles = level_tile_sizes(level, xp)
    sps = level.spatial_loops()
    sdims = {lp.dim for lp in sps}

    ingress: dict[str, Any] = {}
    mfac: dict[str, Any] = {}
    step_delta: dict[str, Any] = {}

    total_steps = 1
    for lp in loops:
        total_steps = total_steps * lp.total_steps()

    for t in op.input_tensors():
        coupled = [lp for lp in loops if t.coupled_to(lp.dim)]
        tile = tensor_volume(t, tiles, xp)
        if not coupled:
            ing = tile
            delta = 0
        else:
            inner = coupled[-1]
            outer_prod = 1
            for lp in coupled[:-1]:
                outer_prod = outer_prod * lp.total_steps()
            n_in = inner.total_steps()
            dvol = tensor_volume(t, tiles, xp,
                                 override=_tile_override(inner, xp))
            dvol = xp.minimum(dvol, tile)
            ing = outer_prod * (tile + (n_in - 1) * dvol)
            # delta = dvol iff `inner` is the advancing loop (the innermost
            # temporal map with >1 steps); computed branch-free so traced
            # tile sizes (mapspace) give the exact same rule as static ints.
            ind = _is_advancing(level, inner, xp)
            delta = ind * dvol + (1 - ind) * tile
        ingress[t.name] = ing
        # destinations per datum across sub-units
        if sps and not any(t.coupled_to(d) for d in sdims):
            mfac[t.name] = level.n_units
        else:
            mfac[t.name] = 1
        step_delta[t.name] = delta if t.has_data else 0
        if not multicast_hw:
            # no multicast HW: the NoC carries one copy per destination
            ingress[t.name] = ingress[t.name] * mfac[t.name]
            step_delta[t.name] = step_delta[t.name] * mfac[t.name]

    # ---- output tensor ------------------------------------------------
    o = op.output
    o_tile = tensor_volume(o, tiles, xp)
    o_coupled = [lp for lp in loops if o.coupled_to(lp.dim)]
    red_dims = op.reduction_dims()
    commits = 1
    for lp in o_coupled:
        commits = commits * lp.total_steps()
    # reduction loops outer to the innermost O-coupled loop force spills
    spill = 1
    if o_coupled:
        # identity search — list.index would value-compare LoopInfo
        # dataclasses, concretizing traced phase fields
        inner_idx = next(i for i, lp in enumerate(loops)
                         if lp is o_coupled[-1])
        for i, lp in enumerate(loops):
            if i < inner_idx and lp.dim in red_dims:
                spill = spill * lp.total_steps()
    else:
        # every loop is a reduction loop; single tile accumulated locally
        commits = 1
    egress_o = o_tile * commits * spill
    readback = o_tile * commits * (spill - 1)
    if spatial_reduction_active(op, level) and not reduction_hw:
        # no spatial-reduction HW: each unit ships its own partial sums up
        egress_o = egress_o * level.n_units
        readback = readback * level.n_units
    # steady per-step egress (amortized drain rate)
    step_egress = xp.ceil_div(egress_o, xp.maximum(total_steps, 1))

    ingress[OUTPUT] = readback
    return LevelTraffic(
        ingress=ingress,
        egress={OUTPUT: egress_o},
        psum_readback=readback,
        multicast_factor=mfac,
        step_delta=step_delta,
        step_egress=step_egress,
        total_steps=total_steps,
        reuse=reuse,
    )
