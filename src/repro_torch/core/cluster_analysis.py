"""Cluster analysis (CLA) engine.

Splits a directive program into cluster levels, derives per-level sub-unit
counts, completes implicit directives, and decomposes every map directive
into *phases* — the (steady, edge) iteration classes whose cross product is
the paper's ``ExtractDataIterationCases`` (Fig. 8).

All arithmetic goes through a tiny backend facade (:class:`Backend`) so that
the exact same formulas run on Python ints (the faithful engine) and on
``torch`` tensors (the batched DSE engine).  Phase *structure* is
static — an edge phase always exists, possibly with occurrence count 0 — so
the tensor twin runs a fixed sequence of ops.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Callable, Mapping, Sequence

from .directives import (Cluster, Dataflow, MapDirective, SpatialMap,
                         TemporalMap, complete)
from .tensor_analysis import LayerOp


# ----------------------------------------------------------------------
# Backend facade
# ----------------------------------------------------------------------

class Backend:
    """Minimal numeric facade. ``py`` works on exact Python ints; ``torch``
    works on tensors (no Python branching on values)."""

    def __init__(self, maximum: Callable, minimum: Callable,
                 where: Callable, floordiv: Callable):
        self.maximum = maximum
        self.minimum = minimum
        self.where = where
        self.floordiv = floordiv

    def ceil_div(self, a, b):
        # The reference's executables fold the two static terms of
        # ``a + b - 1`` into one constant before the add (XLA's algebraic
        # simplifier reassociates ``(C1 + t) - C2`` to ``t + (C1 - C2)``),
        # and in float32 the two orders round differently (2 + 0.1 - 1 is
        # 1.0999999, 0.1 + 1 is 1.1).  Tensors take the folded order; two
        # static operands keep the exact Python path of the faithful engine.
        a_t, b_t = _is_tensor(a), _is_tensor(b)
        if b_t and not a_t:
            return self.floordiv(b + (a - 1), b)
        if a_t and not b_t:
            return self.floordiv(a + (b - 1), b)
        return self.floordiv(a + b - 1, b)

    def eq(self, a, b):
        # returns 1/0 indicator usable in arithmetic
        return self.where(a == b, 1, 0)


def _is_tensor(v) -> bool:
    import torch
    return isinstance(v, torch.Tensor)


def floor_divide(a, b):
    """``jnp.floor_divide`` on float tensors: remainder, subtract, divide,
    sign correction, then ``lax.round``, which rounds half away from zero.
    ``torch.floor_divide`` takes the same steps but rounds a half down (it
    floors and adds one only above one half), so where (a - mod) / b lands
    on k + 1/2, as it can for quotients in [2^22, 2^23), the two differ
    (``floor_divide(11507717.0, 1.5)`` is 7671811 here and in JAX, 7671810
    in torch)."""
    import torch
    mod = torch.fmod(a, b)
    div = (a - mod) / b
    div = torch.where((mod != 0) & ((b < 0) != (mod < 0)), div - 1, div)
    t = torch.trunc(div)
    return torch.where((div - t).abs() >= 0.5, t + torch.sign(div), t)


def py_backend() -> Backend:
    return Backend(
        maximum=lambda a, b: a if a >= b else b,
        minimum=lambda a, b: a if a <= b else b,
        where=lambda c, t, f: t if c else f,
        floordiv=lambda a, b: a // b,
    )


def _scalar_tensor(v, like):
    """0-d tensor for a non-tensor operand, typed as JAX types it with x64
    off: a numpy scalar is strongly typed (int32 / float32 / bool); a Python
    scalar is weakly typed and takes ``like``'s dtype unless a float meets
    an integer or bool tensor (then float32), or an int meets a bool tensor
    (then int32).  With no tensor operand at all JAX's defaults apply."""
    import numpy as np
    import torch
    device = None if like is None else like.device
    if isinstance(v, np.generic):
        dtype = (torch.bool if isinstance(v, np.bool_) else
                 torch.int32 if isinstance(v, np.integer) else torch.float32)
        return torch.tensor(v.item(), dtype=dtype, device=device)
    if isinstance(v, bool):
        dtype = torch.bool if like is None else like.dtype
    elif isinstance(v, float):
        dtype = like.dtype if like is not None and like.is_floating_point() \
            else torch.float32
    else:
        dtype = like.dtype if like is not None and like.dtype != torch.bool \
            else torch.int32
    return torch.tensor(v, dtype=dtype, device=device)


def _tensors(*vals):
    """Lift the non-tensor operands of one op to 0-d tensors on the device
    of its tensor operands (``torch.maximum`` and friends take tensors
    only), without changing the result dtype JAX would give."""
    import torch
    like = next((v for v in vals if isinstance(v, torch.Tensor)), None)
    if like is None:
        lifted = [_scalar_tensor(v, None) if not isinstance(v, (int, float))
                  else v for v in vals]
        like = next((v for v in lifted if isinstance(v, torch.Tensor)), None)
        vals = tuple(lifted)
    return tuple(v if isinstance(v, torch.Tensor) else _scalar_tensor(v, like)
                 for v in vals)


def _t_maximum(a, b):
    import torch
    return torch.maximum(*_tensors(a, b))


def _t_minimum(a, b):
    import torch
    return torch.minimum(*_tensors(a, b))


def _t_where(c, t, f):
    import torch
    c, = _tensors(c)
    return torch.where(c.to(torch.bool), *_tensors(t, f))


def _t_floordiv(a, b):
    import torch
    a, b = _tensors(a, b)
    if torch.result_type(a, b).is_floating_point:
        return floor_divide(a, b)
    return torch.floor_divide(a, b)


def torch_backend() -> Backend:
    """Every operation as a torch op, static operands included (the
    counterpart of the reference's all-``jnp`` backend)."""
    return Backend(maximum=_t_maximum, minimum=_t_minimum, where=_t_where,
                   floordiv=_t_floordiv)


def hybrid_backend() -> Backend:
    """Python math on static ints, torch ops on tensors.

    This keeps everything derivable from (layer dims × directive sizes) —
    trip counts of temporal loops, tile sizes, case structure — as exact
    Python ints even while hardware parameters (PE count, NoC bandwidth)
    are (n,)-shaped tensors, so the batched engine runs a small op graph
    and stays bit-identical to the faithful engine.  Numpy scalars are not
    static: like the reference, they go to the tensor path, typed as JAX
    types them."""

    def _static(*vals) -> bool:
        return all(isinstance(v, (int, float, bool)) for v in vals)

    def maximum(a, b):
        return (a if a >= b else b) if _static(a, b) else _t_maximum(a, b)

    def minimum(a, b):
        return (a if a <= b else b) if _static(a, b) else _t_minimum(a, b)

    def where(c, t, f):
        if _static(c):
            return t if c else f
        return _t_where(c, t, f)

    def floordiv(a, b):
        return a // b if _static(a, b) else _t_floordiv(a, b)

    return Backend(maximum=maximum, minimum=minimum, where=where,
                   floordiv=floordiv)


# ----------------------------------------------------------------------
# Phases
# ----------------------------------------------------------------------

@dataclasses.dataclass
class Phase:
    """One iteration class of a map directive.

    count        number of (temporal) steps, or spatial folds, in this class
    size         per-unit mapped extent of the dim (max across units)
    active       number of fully-active sub-units (1 for temporal maps)
    partial_size extent of the trailing partially-filled unit (0 if none)
    """
    count: Any
    size: Any
    active: Any = 1
    partial_size: Any = 0

    @property
    def units(self):
        """Total units doing work (full + the partial straggler)."""
        return self.active if isinstance(self.partial_size, int) and \
            self.partial_size == 0 else None  # only used by py backend


@dataclasses.dataclass
class LoopInfo:
    """A map directive instantiated at a cluster level."""
    directive: MapDirective
    dim: str
    is_spatial: bool
    n_units: Any              # sub-units the spatial map distributes over
    steady: Phase
    edge: Phase

    @property
    def phases(self) -> tuple[Phase, Phase]:
        return (self.steady, self.edge)

    def total_steps(self):
        return self.steady.count + self.edge.count


def temporal_phases(xp: Backend, D, size, offset) -> tuple[Phase, Phase]:
    """Iteration classes of ``TemporalMap(size, offset)`` over a dim of
    extent ``D``: ``n = 1 + ceil((D - s)/o)`` steps, the last possibly
    partial."""
    s = xp.minimum(size, D)
    n = 1 + xp.ceil_div(xp.maximum(D - s, 0), offset)
    last = D - (n - 1) * offset          # extent of the final step
    last = xp.minimum(xp.maximum(last, 1), s)
    has_edge = 1 - xp.eq(last, s)
    steady = Phase(count=n - has_edge, size=s)
    edge = Phase(count=has_edge, size=last)
    return steady, edge


def spatial_phases(xp: Backend, D, size, offset, n_units
                   ) -> tuple[Phase, Phase]:
    """Folding classes of ``SpatialMap(size, offset)`` over ``n_units``
    sub-units (paper §3.2: insufficient PEs ⇒ the mapping folds over time).

    A full fold covers ``span = s + (n-1)·o`` indices and advances by
    ``n·o``; the final fold may activate fewer units and/or a partial
    trailing unit."""
    s = xp.minimum(size, D)
    adv = n_units * offset
    span = s + (n_units - 1) * offset
    n_folds = 1 + xp.ceil_div(xp.maximum(D - span, 0), adv)
    rem = D - (n_folds - 1) * adv        # indices left for the last fold
    rem = xp.minimum(rem, span)
    # units whose window [u·o, u·o + s) intersects [0, rem): u·o < rem
    used = xp.minimum(n_units, xp.ceil_div(rem, offset))
    # among used units, those fully covered: u·o + s <= rem
    full = xp.minimum(used, xp.maximum(
        xp.floordiv(rem - s, offset) + 1, 0))
    partial_cnt = used - full
    last_partial = xp.maximum(rem - full * offset, 0)
    last_partial = xp.minimum(last_partial, s)
    is_steady_last = xp.eq(full, n_units)
    steady = Phase(count=n_folds - 1 + is_steady_last, size=s,
                   active=n_units, partial_size=0)
    edge = Phase(count=1 - is_steady_last, size=s, active=full,
                 partial_size=xp.where(partial_cnt > 0, last_partial, 0))
    return steady, edge


# ----------------------------------------------------------------------
# Order-oblivious (dense) level representation
# ----------------------------------------------------------------------
#
# The universal structure-as-operand evaluator (core.vectorized /
# repro.mapspace.universal) cannot branch on loop *order* or on which
# directive is spatial — those are traced operands.  A DenseLevel therefore
# carries per-dim quantities over a fixed dim universe: the loop order as a
# rank vector (higher rank = closer to the innermost position), the spatial
# choice as a 0/1 one-hot, and per-dim phases blended between their
# temporal and spatial forms by that one-hot.  Dims that are not loops at a
# level pass their extent through untouched (trip-count-1 behaviour), which
# is exactly how ``complete()`` treats unmentioned dims in the faithful
# engine.

def mix(xp: Backend, s, a, b):
    """Branch-free select ``s ? a : b`` for a 0/1 indicator ``s`` (exact for
    the small-integer quantities the analysis manipulates).  Static 0/1
    indicators short-circuit so the hybrid backend keeps Python ints."""
    if isinstance(s, (int, float, bool)):
        return a if s else b
    return s * a + (1 - s) * b


@dataclasses.dataclass
class DenseLevel:
    """Order-oblivious twin of :class:`LevelSpec`.

    ``rank`` holds each loop's position in the data-movement order (any
    strictly increasing outer->inner numbering; values may be traced).
    ``sp`` holds the spatial one-hot.  ``steady``/``edge`` hold per-dim
    phases already blended between spatial and temporal semantics, and
    ``off_eff`` the stride-scaled offsets (the CLA stride rule)."""
    index: int
    ext: dict[str, Any]                # dim universe extents at this level
    loop_dims: tuple[str, ...]         # dims that are loops here (static)
    edge_dims: tuple[str, ...]         # loops whose edge phase is enumerated
    rank: dict[str, Any]               # loop-order position per loop dim
    sp: dict[str, Any]                 # spatial one-hot per loop dim
    steady: dict[str, Phase]
    edge: dict[str, Phase]
    off_eff: dict[str, Any]            # stride-scaled offsets per loop dim
    n_units: Any
    is_innermost: bool
    single_edge: bool = False          # divisor-tiled: A+1 cases, not 2^A

    def trips(self, d: str):
        return self.steady[d].count + self.edge[d].count


def build_dense_level(xp: Backend, op: LayerOp, *, index: int,
                      ext: Mapping[str, Any], sizes: Mapping[str, Any],
                      offsets: Mapping[str, Any], rank: Mapping[str, Any],
                      sp: Mapping[str, Any], loop_dims: Sequence[str],
                      edge_dims: Sequence[str], n_units: Any,
                      innermost: bool, single_edge: bool = False
                      ) -> DenseLevel:
    """Instantiate one dense level: per-dim phases computed both ways
    (temporal and spatial) and blended by the spatial one-hot, extending the
    branch-free advancing-loop rule from tile sizes to structure."""
    steady: dict[str, Phase] = {}
    edge: dict[str, Phase] = {}
    off_eff: dict[str, Any] = {}
    for d in loop_dims:
        D = ext[d]
        off = offsets[d] * op.stride_of(d)
        off_eff[d] = off
        st_t, ed_t = temporal_phases(xp, D, sizes[d], off)
        s = sp.get(d, 0)
        if isinstance(s, (int, float)) and s == 0:
            steady[d], edge[d] = st_t, ed_t
            continue
        st_s, ed_s = spatial_phases(xp, D, sizes[d], off, n_units)
        steady[d] = Phase(
            count=mix(xp, s, st_s.count, st_t.count),
            size=st_t.size,  # min(size, D) either way
            active=mix(xp, s, st_s.active, 1),
            partial_size=mix(xp, s, st_s.partial_size, 0))
        edge[d] = Phase(
            count=mix(xp, s, ed_s.count, ed_t.count),
            size=mix(xp, s, ed_s.size, ed_t.size),
            active=mix(xp, s, ed_s.active, 1),
            partial_size=mix(xp, s, ed_s.partial_size, 0))
    return DenseLevel(
        index=index, ext=dict(ext), loop_dims=tuple(loop_dims),
        edge_dims=tuple(edge_dims), rank=dict(rank), sp=dict(sp),
        steady=steady, edge=edge, off_eff=off_eff, n_units=n_units,
        is_innermost=innermost, single_edge=single_edge)


def enumerate_cases_dense(level: DenseLevel, xp: Backend,
                          single_edge: bool = False
                          ) -> list["IterationCase"]:
    """Dense twin of :func:`enumerate_cases`: the phase cross product runs
    over ``edge_dims`` only (loops whose sizes are operands and may or may
    not divide their dim); every other loop contributes its steady phase.
    The first case is the all-steady case, as in the faithful engine.

    ``single_edge`` restricts the product to the all-steady case plus one
    edge per dim (A+1 cases instead of 2^A).  Exact for divisor-tiled
    spaces (``repro.mapspace``): temporal divisor tiles never produce an
    edge phase, so at most one loop — the spatially mapped one, which
    folds over the PE array — has a non-zero edge count, and every
    multi-edge case carries zero occurrences."""
    if single_edge:
        masks = [tuple(0 for _ in level.edge_dims)]
        for i in range(len(level.edge_dims)):
            masks.append(tuple(int(j == i)
                               for j in range(len(level.edge_dims))))
    else:
        masks = itertools.product((0, 1), repeat=len(level.edge_dims))
    cases: list[IterationCase] = []
    for mask in masks:
        choice = dict(zip(level.edge_dims, mask))
        occ = 1
        sizes = dict(level.ext)
        active = 1
        partials: dict[str, Any] = {}
        for d in level.loop_dims:
            ph = level.edge[d] if choice.get(d, 0) else level.steady[d]
            sizes[d] = ph.size
            occ = occ * ph.count
            # temporal phases have active == 1 / partial == 0, so plain
            # products reproduce the engine's min-over-spatial-loops
            active = active * ph.active
            partials[d] = ph.partial_size
        cases.append(IterationCase(
            occurrences=occ, sizes=sizes, active_units=active,
            partial_unit_sizes=partials, phase_ids=tuple(mask)))
    return cases


# ----------------------------------------------------------------------
# Level construction
# ----------------------------------------------------------------------

@dataclasses.dataclass
class LevelSpec:
    """One cluster level: its loops (outer→inner) and sub-unit count."""
    index: int
    loops: tuple[LoopInfo, ...]
    n_units: Any                 # sub-clusters (PEs at the innermost level)
    dims: dict[str, Any]         # dim extents seen by this level
    is_innermost: bool

    def spatial_loop(self) -> LoopInfo | None:
        for lp in self.loops:
            if lp.is_spatial:
                return lp
        return None

    def spatial_loops(self) -> tuple[LoopInfo, ...]:
        return tuple(lp for lp in self.loops if lp.is_spatial)

    def steady_tile(self) -> dict[str, Any]:
        """Per-sub-unit steady mapped extents (unmapped dims pass through)."""
        m = dict(self.dims)
        for lp in self.loops:
            m[lp.dim] = lp.steady.size
        return m


def unit_counts(xp: Backend, num_pes, cluster_sizes: Sequence[int]
                ) -> list[Any]:
    """Sub-unit count per level: ``[P/Πc, c1, ..., cL]`` (paper §3.2).

    Cluster sizes are capped by the PEs actually available, innermost
    first — an 8-PE machine running a ``Cluster(64)`` dataflow forms one
    8-wide cluster (which then folds), not a phantom 64-wide one."""
    eff: list[Any] = [None] * len(cluster_sizes)
    rem = xp.maximum(num_pes, 1)
    for i in range(len(cluster_sizes) - 1, -1, -1):
        ce = xp.maximum(xp.minimum(cluster_sizes[i], rem), 1)
        eff[i] = ce
        rem = xp.maximum(xp.floordiv(rem, ce), 1)
    top = rem
    return [top, *eff]


def build_levels(xp: Backend, df: Dataflow, op: LayerOp, num_pes
                 ) -> list[LevelSpec]:
    """Instantiate every cluster level against the layer.

    Level ``l+1`` sees dim extents equal to level ``l``'s steady per-unit
    mapped sizes (paper §4.4: multi-cluster splits into single-cluster cases
    with dim size = the upper level's mapping size)."""
    df = complete(df, op.dims)
    counts = unit_counts(xp, num_pes, df.cluster_sizes)
    level_maps = df.levels
    levels: list[LevelSpec] = []
    dims: dict[str, Any] = dict(op.dims)
    for li, maps in enumerate(level_maps):
        n_units = counts[li]
        loops: list[LoopInfo] = []
        for d in maps:
            D = dims[d.dim]
            if isinstance(d, SpatialMap):
                steady, edge = spatial_phases(xp, D, d.size, d.offset,
                                              n_units)
                loops.append(LoopInfo(d, d.dim, True, n_units, steady, edge))
            else:
                steady, edge = temporal_phases(xp, D, d.size, d.offset)
                loops.append(LoopInfo(d, d.dim, False, 1, steady, edge))
        spec = LevelSpec(index=li, loops=tuple(loops), n_units=n_units,
                         dims=dict(dims),
                         is_innermost=(li == len(level_maps) - 1))
        levels.append(spec)
        dims = spec.steady_tile()
    return levels


# ----------------------------------------------------------------------
# Case enumeration (the paper's ExtractDataIterationCases)
# ----------------------------------------------------------------------

@dataclasses.dataclass
class IterationCase:
    """One element of the cross product of per-loop phases."""
    occurrences: Any             # product of phase counts
    sizes: dict[str, Any]        # per-unit mapped extent per dim
    active_units: Any            # fully-active sub-units this case
    partial_unit_sizes: dict[str, Any]  # spatial dim -> trailing unit extent
    phase_ids: tuple[int, ...]   # 0=steady / 1=edge per loop (for debugging)


def enumerate_cases(level: LevelSpec, xp: Backend) -> list[IterationCase]:
    """Cross product of per-loop phases; occurrence = Π phase counts.

    The structure (number of cases) is static per dataflow; counts may be 0
    (e.g. when a dim divides evenly there is no edge), which keeps the tensor
    twin branch-free.

    Multiple SpatialMaps at a level are *aligned* (unit u takes chunk u of
    every spatial dim): the first spatial loop drives folding; secondary
    spatial loops contribute sizes and clamp the jointly-active unit count
    via ``min``.  Secondary loops must cover their dim in a single fold
    (true of all Table 3 dataflows)."""
    first_spatial = next((i for i, lp in enumerate(level.loops)
                          if lp.is_spatial), None)
    loop_phase_lists: list[tuple[Phase, ...]] = []
    for i, lp in enumerate(level.loops):
        if lp.is_spatial and i != first_spatial:
            # Aligned secondary spatial map: the primary drives time, so a
            # secondary never contributes fold steps.  Collapse it to its
            # covering phase (first fold).  On an under-provisioned
            # cluster (fewer PEs than the dim) the uncovered tail is
            # honestly dropped — the mapping simply cannot express it.
            st, ed = lp.phases
            if isinstance(st.count, int) and isinstance(ed.count, int):
                loop_phase_lists.append((st if st.count >= 1 else ed,))
                continue
        loop_phase_lists.append(lp.phases)
    cases: list[IterationCase] = []
    for choice in itertools.product(
            *[range(len(p)) for p in loop_phase_lists]):
        occ = 1
        sizes = dict(level.dims)
        active = None
        partials: dict[str, Any] = {}
        for i, (lp, phs, ci) in enumerate(
                zip(level.loops, loop_phase_lists, choice)):
            ph = phs[ci]
            sizes[lp.dim] = ph.size
            if lp.is_spatial and i != first_spatial:
                occ = occ * xp.where(ph.count > 0, 1, 0)
            else:
                occ = occ * ph.count
            if lp.is_spatial:
                active = ph.active if active is None \
                    else xp.minimum(active, ph.active)
                partials[lp.dim] = ph.partial_size
        cases.append(IterationCase(
            occurrences=occ, sizes=sizes,
            active_units=1 if active is None else active,
            partial_unit_sizes=partials, phase_ids=choice))
    return cases
