"""Mapping-space definition: the legal data-centric programs for a layer.

The paper's 480M-design search has two axes: hardware (``core.dse``) and
*mapping* — which this module defines.  A candidate mapping is encoded as a
small integer gene tuple::

    point = (spatial_idx, perm_idx, cluster_idx, tile_0, ..., tile_{A-1})

over a :class:`MapSpace` with

  * one :class:`TileAxis` per searched layer dim, whose candidate tile sizes
    come from the dim's divisor set (``directives.tile_candidates``) — for
    sliding-window outer dims (Y/X of a conv) candidates tile the *output*
    extent and carry the input halo, so every tile yields whole outputs;
  * a choice of which axis is spatially mapped (the paper's partitioning
    strategy, Table 3's "-P" suffix);
  * a permutation of the axes (the data-movement order);
  * an optional second cluster level (``Cluster(c); SpatialMap(1,1) d`` —
    the NVDLA/Eyeriss-style nesting of Table 3).

Window dims themselves (R/S) are pinned fully-unrolled with symbolic
``Sz(...)`` sizes, exercising ``resolve``/``complete`` exactly like the
Table 3 programs.  Legality is enforced at construction: every tile size
divides (window dims: tiles the output of) its dim, so no directive ever
exceeds its extent — points never need post-hoc filtering.

Points sharing ``(spatial_idx, perm_idx, cluster_idx)`` share one directive
*structure* and differ only in tile sizes, which is precisely the grouping
the batched evaluator (``mapspace.batched``) vectorizes over.
"""
from __future__ import annotations

import dataclasses
import hashlib
import itertools
from typing import Iterator, Sequence

import numpy as np

from ..core.directives import (Cluster, Dataflow, SpatialMap, Sz,
                               TemporalMap, tile_candidates)
from ..core.tensor_analysis import ConvExpr, LayerOp

Point = tuple  # (spatial_idx, perm_idx, cluster_idx, *tile_idxs)
GroupKey = tuple  # (spatial_idx, perm_idx, cluster_idx)


@dataclasses.dataclass(frozen=True)
class TileAxis:
    """Candidate (size, offset) pairs for one searched dim.  For window-outer
    dims the offset is in *output* steps (the engine stride-scales it), for
    plain dims offset == size (disjoint tiling — no recompute)."""
    dim: str
    sizes: tuple[int, ...]
    offsets: tuple[int, ...]

    def __post_init__(self) -> None:
        if len(self.sizes) != len(self.offsets) or not self.sizes:
            raise ValueError(f"axis {self.dim}: sizes/offsets mismatch")

    @property
    def n(self) -> int:
        return len(self.sizes)


@dataclasses.dataclass(frozen=True)
class ClusterOption:
    """Second cluster level: ``Cluster(size); SpatialMap(inner_size,
    inner_offset) inner_dim``.  For window-outer inner dims (X/Y of a conv)
    the inner map slides — ``SpatialMap(Sz(S),1) X`` — which is exactly the
    ShiDianNao/Eyeriss-style nesting of Table 3's YX-P/YR-P; plain dims get
    the NVDLA-style unit mapping ``SpatialMap(1,1)``."""
    size: int
    inner_dim: str
    inner_size: int | Sz = 1
    inner_offset: int | Sz = 1


@dataclasses.dataclass(frozen=True)
class MapSpace:
    op_name: str
    dims: tuple[tuple[str, int], ...]       # layer dims (fingerprint anchor)
    axes: tuple[TileAxis, ...]
    perms: tuple[tuple[int, ...], ...]      # axis-index orderings
    spatial_choices: tuple[int, ...]        # axis indices
    cluster_options: tuple[ClusterOption | None, ...]
    pinned: tuple[str, ...]                 # window dims, fully unrolled

    # ------------------------------------------------------------------
    @property
    def size(self) -> int:
        n = len(self.spatial_choices) * len(self.perms) \
            * len(self.cluster_options)
        for ax in self.axes:
            n *= ax.n
        return n

    @property
    def n_groups(self) -> int:
        return len(self.spatial_choices) * len(self.perms) \
            * len(self.cluster_options)

    def group_key(self, point: Point) -> GroupKey:
        return tuple(point[:3])

    def group_keys(self) -> list[GroupKey]:
        return [  # deterministic order: spatial outer, then perm, cluster
            (s, p, c)
            for s in range(len(self.spatial_choices))
            for p in range(len(self.perms))
            for c in range(len(self.cluster_options))]

    def gene_ranges(self) -> tuple[int, ...]:
        return (len(self.spatial_choices), len(self.perms),
                len(self.cluster_options)) + tuple(ax.n for ax in self.axes)

    def fingerprint(self) -> str:
        txt = "|".join([
            self.op_name, str(self.dims),
            str([(ax.dim, ax.sizes, ax.offsets) for ax in self.axes]),
            str(self.perms), str(self.spatial_choices),
            str(self.cluster_options), str(self.pinned)])
        return hashlib.sha256(txt.encode()).hexdigest()[:16]


class MapSpaceError(ValueError):
    pass


# ----------------------------------------------------------------------
# Construction
# ----------------------------------------------------------------------

def _window_info(op: LayerOp) -> dict[str, tuple[str, int]]:
    """outer dim -> (window dim, stride) for the op's output sliding
    windows (input-centric convs)."""
    out = {}
    for e in op.output.entries:
        if isinstance(e, ConvExpr):
            out[e.outer] = (e.window, e.stride)
    return out


def _pinned_dims(op: LayerOp) -> tuple[str, ...]:
    """Window (filter-tap) dims: R/S of a conv — pinned fully unrolled."""
    pinned = []
    for t in (op.output, op.input):
        for e in t.entries:
            w = getattr(e, "window", None)
            if w and w in op.dims and w not in pinned:
                pinned.append(w)
    return tuple(pinned)


def build_space(op: LayerOp, *,
                dims: Sequence[str] | None = None,
                spatial_dims: Sequence[str] | None = None,
                max_tiles_per_dim: int = 6,
                perm_mode: str = "auto",
                cluster: bool = True,
                cluster_sizes: Sequence[int] = (64,),
                cluster_inner_dims: Sequence[str] | None = None) -> MapSpace:
    """Derive the default legal mapping space for ``op``.

    ``perm_mode``: ``"all"`` enumerates every axis ordering, ``"rotations"``
    only the cyclic shifts of the canonical order (one choice of innermost
    axis each — the order decision that dominates reuse), ``"auto"`` picks
    ``all`` for ≤3 axes else ``rotations``.  Keeping the structural axes
    small matters: each (spatial × perm × cluster) combination is a separate
    XLA executable; tile axes are free (vectorized).
    """
    windows = _window_info(op)
    pinned = _pinned_dims(op)
    if dims is None:
        dims = [d for d in op.dims
                if op.dims[d] > 1 and d not in pinned and d != "N"]
    dims = list(dims)
    if not dims:
        raise MapSpaceError(f"{op.name}: no searchable dims")
    for d in dims:
        if d not in op.dims:
            raise MapSpaceError(f"{op.name}: unknown dim {d!r}")
        if d in pinned:
            raise MapSpaceError(f"{op.name}: {d!r} is a window dim (pinned)")

    axes = []
    for d in dims:
        extent = op.dims[d]
        if d in windows:
            w, stride = windows[d]
            out_extent = (extent - op.dims[w]) // stride + 1
            cand = tile_candidates(max(out_extent, 1), max_tiles_per_dim)
            sizes = tuple((t - 1) * stride + op.dims[w] for t in cand)
            offsets = cand  # output steps; the CLA engine stride-scales
        else:
            cand = tile_candidates(extent, max_tiles_per_dim)
            sizes = offsets = cand
        axes.append(TileAxis(d, sizes, offsets))

    a = len(axes)
    if perm_mode == "auto":
        perm_mode = "all" if a <= 3 else "rotations"
    if perm_mode == "all":
        perms = tuple(itertools.permutations(range(a)))
    elif perm_mode == "rotations":
        base = tuple(range(a))
        perms = tuple(base[r:] + base[:r] for r in range(a))
    else:
        raise MapSpaceError(f"unknown perm_mode {perm_mode!r}")

    if spatial_dims is None:
        spatial_dims = dims
    spatial_choices = tuple(dims.index(d) for d in spatial_dims)

    options: list[ClusterOption | None] = [None]
    if cluster:
        if cluster_inner_dims is None:
            red = op.reduction_dims()
            cluster_inner_dims = [d for d in dims
                                  if d in red and op.dims[d] > 1][:1]
            # plus one sliding-window inner (the YX-P/YR-P nesting style)
            win_outer = [d for d in windows if op.dims[d] > 1]
            cluster_inner_dims += win_outer[-1:]
        for d in cluster_inner_dims:
            if d in windows:
                w, stride = windows[d]
                useful = (op.dims[d] - op.dims[w]) // stride + 1
                inner: tuple = (Sz(w), 1)
            else:
                useful = op.dims[d]
                inner = (1, 1)
            for c in dict.fromkeys(min(c, useful) for c in cluster_sizes):
                if c > 1:
                    options.append(ClusterOption(c, d, *inner))

    return MapSpace(
        op_name=op.name,
        dims=tuple(sorted(op.dims.items())),
        axes=tuple(axes),
        perms=perms,
        spatial_choices=spatial_choices,
        cluster_options=tuple(options),
        pinned=pinned,
    )


# ----------------------------------------------------------------------
# Point <-> Dataflow
# ----------------------------------------------------------------------

def point_dataflow(space: MapSpace, point: Point,
                   name: str | None = None) -> Dataflow:
    """Materialize one gene tuple as a concrete directive program."""
    s_i, p_i, c_i = point[:3]
    tiles = point[3:]
    spatial_axis = space.spatial_choices[s_i]
    dirs = []
    for ai in space.perms[p_i]:
        ax = space.axes[ai]
        t = tiles[ai]
        cls = SpatialMap if ai == spatial_axis else TemporalMap
        dirs.append(cls(ax.sizes[t], ax.offsets[t], ax.dim))
    for d in space.pinned:
        dirs.append(TemporalMap(Sz(d), Sz(d), d))
    copt = space.cluster_options[c_i]
    if copt is not None:
        dirs.append(Cluster(copt.size))
        dirs.append(SpatialMap(copt.inner_size, copt.inner_offset,
                               copt.inner_dim))
    if name is None:
        name = f"ms:{space.op_name}:" + "-".join(str(g) for g in point)
    return Dataflow(name, tuple(dirs))


def group_template(space: MapSpace, key: GroupKey
                   ) -> tuple[Dataflow, tuple[int, ...]]:
    """Placeholder program + variable directive slots for one structural
    group.  Operand column ``j`` of the batched evaluator corresponds to the
    ``j``-th directive, i.e. axis ``space.perms[p][j]``."""
    s_i, p_i, c_i = key
    point = (s_i, p_i, c_i) + tuple(0 for _ in space.axes)
    df = point_dataflow(space, point, name=f"ms-tmpl:{space.op_name}:"
                                           f"{s_i}-{p_i}-{c_i}")
    return df, tuple(range(len(space.axes)))


def point_operands(space: MapSpace, points: Sequence[Point]
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Stack (sizes, offsets) operand rows for points of ONE group, columns
    in the group's perm order."""
    p_i = points[0][1]
    perm = space.perms[p_i]
    n, a = len(points), len(space.axes)
    sizes = np.empty((n, a), np.float32)
    offsets = np.empty((n, a), np.float32)
    for i, pt in enumerate(points):
        tiles = pt[3:]
        for j, ai in enumerate(perm):
            ax = space.axes[ai]
            sizes[i, j] = ax.sizes[tiles[ai]]
            offsets[i, j] = ax.offsets[tiles[ai]]
    return sizes, offsets


def pad_tile_axes(space: MapSpace, counts: Sequence[int]) -> MapSpace:
    """Pad each tile axis to ``counts[ai]`` candidates by repeating its last
    (full-extent) candidate — the same padding rule ``gene_tables`` applies
    internally.  Padded spaces of different layers share identical
    ``gene_ranges()``, which is what lets ``repro_torch.netspace`` use ONE
    gene layout (and one evaluator) across every layer of an op-class;
    duplicate candidates introduced by padding are analysis-equivalent and
    collapse in ``dedupe_equivalent_genes``."""
    axes = []
    for ax, n in zip(space.axes, counts):
        if n < ax.n:
            raise MapSpaceError(
                f"axis {ax.dim}: cannot pad {ax.n} candidates down to {n}")
        pad = n - ax.n
        axes.append(TileAxis(
            ax.dim, ax.sizes + (ax.sizes[-1],) * pad,
            ax.offsets + (ax.offsets[-1],) * pad))
    return dataclasses.replace(space, axes=tuple(axes))


# ----------------------------------------------------------------------
# Space pruning: equivalent-permutation dedupe + buffer-budget bounds
# ----------------------------------------------------------------------

def _resolve_sz(v, op: LayerOp) -> int:
    return op.dims[v.dim] if isinstance(v, Sz) else int(v)


def _point_ranks(space: MapSpace, op: LayerOp, point: Point
                 ) -> tuple[dict[str, float], dict[str, int]]:
    """Loop-order ranks (higher = inner) and trip counts per dim for one
    point, mirroring the grouped templates: implicit dims outermost,
    searched axes in permutation order, pinned window dims innermost."""
    s_i, p_i, c_i = point[:3]
    tiles = point[3:]
    a = len(space.axes)
    rank: dict[str, float] = {}
    trips: dict[str, int] = {}
    searched = {ax.dim for ax in space.axes}
    missing = [d for d in op.dims
               if d not in searched and d not in space.pinned]
    for i, d in enumerate(missing):
        rank[d] = -1 - i
        trips[d] = 1
    spatial_axis = space.spatial_choices[s_i]
    for pos, ai in enumerate(space.perms[p_i]):
        ax = space.axes[ai]
        rank[ax.dim] = pos
        ext = op.dims[ax.dim]
        size = min(ax.sizes[tiles[ai]], ext)
        off = ax.offsets[tiles[ai]] * op.stride_of(ax.dim)
        if ai == spatial_axis:
            # spatial folding depends on the PE count, unknown here —
            # conservatively treat the spatial loop as multi-trip so it is
            # never deduped out of the order signature
            trips[ax.dim] = 2
        else:
            trips[ax.dim] = 1 + -(-max(ext - size, 0) // off)
    for j, d in enumerate(space.pinned):
        rank[d] = a + j
        trips[d] = 1
    return rank, trips


def canonical_signature(op: LayerOp, space: MapSpace, point: Point
                        ) -> tuple:
    """Equivalence signature: two points with equal signatures produce
    bit-identical analysis results even when their permutation genes
    differ.

    Permutations that differ only in the position of trip-count-1 loops
    (tile size covering the whole dim) are *almost* interchangeable; the
    engine's residual order sensitivities are the identity of each
    tensor's innermost coupled loop and which reduction loops sit outer to
    the output's innermost coupled loop (the psum-spill rule).  The
    signature captures exactly those, so deduping on it is lossless."""
    s_i, p_i, c_i = point[:3]
    tiles = point[3:]
    rank, trips = _point_ranks(space, op, point)
    perm_order = tuple(ai for ai in space.perms[p_i]
                       if trips[space.axes[ai].dim] > 1)
    inners = []
    for t in op.tensors():
        cl = [d for d in rank if t.coupled_to(d)]
        inners.append(max(cl, key=rank.get) if cl else None)
    ocl = [d for d in rank if op.output.coupled_to(d)]
    red_flags: tuple = ()
    if ocl:
        inner_o = max(ocl, key=rank.get)
        red_flags = tuple(
            sorted(d for d in rank
                   if d in op.reduction_dims() and trips[d] > 1
                   and rank[d] < rank[inner_o]))
    return (s_i, c_i, tiles, perm_order, tuple(inners), red_flags)


def dedupe_equivalent_points(op: LayerOp, space: MapSpace,
                             points: Sequence[Point]
                             ) -> tuple[list[Point], list[int]]:
    """Collapse analysis-equivalent points (ROADMAP "richer space
    pruning").  Returns ``(representatives, rep_index_per_point)`` so
    callers evaluate only the representatives and scatter features back."""
    reps: list[Point] = []
    index: dict[tuple, int] = {}
    back: list[int] = []
    for pt in points:
        sig = canonical_signature(op, space, pt)
        at = index.get(sig)
        if at is None:
            at = len(reps)
            index[sig] = at
            reps.append(pt)
        back.append(at)
    return reps, back


def buffer_estimate_kb(op: LayerOp, space: MapSpace, point: Point,
                       dtype_bytes: int = 2) -> tuple[float, float]:
    """Closed-form (L1, L2) working-set lower bounds in KB for one point —
    double-buffered per-PE tile and per-level steady tile.  Lower bounds by
    construction (spatial spans only grow the true L2 requirement), so
    budget pruning never drops a feasible mapping."""
    sizes = dict(op.dims)
    for ai, ax in enumerate(space.axes):
        sizes[ax.dim] = min(ax.sizes[point[3 + ai]], op.dims[ax.dim])
    l2 = 2 * sum(t.volume(sizes) for t in op.tensors())
    inner = dict(sizes)
    copt = space.cluster_options[point[2]]
    if copt is not None:
        inner[copt.inner_dim] = min(_resolve_sz(copt.inner_size, op),
                                    inner[copt.inner_dim])
    l1 = 2 * sum(t.volume(inner) for t in op.tensors())
    return (l1 * dtype_bytes / 1024.0, l2 * dtype_bytes / 1024.0)


def prune_by_budget(op: LayerOp, space: MapSpace,
                    points: Sequence[Point], *,
                    l1_kb: float | None = None,
                    l2_kb: float | None = None,
                    dtype_bytes: int = 2) -> list[Point]:
    """Drop points whose working-set lower bound exceeds the L1/L2 buffer
    budget — before any evaluation (ROADMAP "bound tile sets by buffer
    budgets")."""
    if l1_kb is None and l2_kb is None:
        return list(points)
    out = []
    for pt in points:
        e1, e2 = buffer_estimate_kb(op, space, pt, dtype_bytes)
        if l1_kb is not None and e1 > l1_kb:
            continue
        if l2_kb is not None and e2 > l2_kb:
            continue
        out.append(pt)
    return out


# ----------------------------------------------------------------------
# Gene matrices: the vectorized native currency of the search
# ----------------------------------------------------------------------
#
# A *gene matrix* is an ``(n, G)`` int64 array whose rows are points in
# gene-tuple layout: ``(spatial_idx, perm_idx, cluster_idx, tile_0, ...,
# tile_{A-1})``.  Everything the search pipeline does per point — index
# decode, operand encode, equivalence signatures, buffer bounds — is
# expressed as numpy gathers over per-space lookup tables, so the host
# side scales to millions of candidates without Python per-point loops.

def genes_from_points(points: Sequence[Point]) -> np.ndarray:
    """Stack tuple points into an (n, G) int64 gene matrix."""
    return np.asarray(points, dtype=np.int64).reshape(len(points), -1)


def points_from_genes(genes: np.ndarray) -> list[Point]:
    """Gene matrix rows back to tuple points (API edges only)."""
    return [tuple(int(g) for g in row) for row in np.asarray(genes)]


def decode_indices(space: MapSpace, idx) -> np.ndarray:
    """Mixed-radix flat index -> gene matrix, vectorized.

    The digit order matches :func:`enumerate_points`: structural genes
    outermost (spatial, then perm, then cluster), tile genes innermost with
    the LAST axis fastest — so ``decode_indices(space, np.arange(n))``
    reproduces the first ``n`` enumerated points exactly."""
    idx = np.ascontiguousarray(np.asarray(idx, dtype=np.int64))
    radices = space.gene_ranges()
    out = np.empty((idx.shape[0], len(radices)), dtype=np.int64)
    for j in range(len(radices) - 1, -1, -1):
        out[:, j] = idx % radices[j]
        idx = idx // radices[j]
    return out


def flat_index(space: MapSpace, genes: np.ndarray) -> np.ndarray:
    """Inverse of :func:`decode_indices`: gene rows -> flat int64 indices
    (used for O(1) distinctness bookkeeping during sampling/search)."""
    genes = np.asarray(genes, dtype=np.int64)
    radices = space.gene_ranges()
    flat = np.zeros(genes.shape[0], dtype=np.int64)
    for j in range(len(radices)):
        flat = flat * radices[j] + genes[:, j]
    return flat


def enumerate_genes(space: MapSpace, start: int = 0,
                    stop: int | None = None) -> np.ndarray:
    """Vectorized enumeration: gene rows ``start..stop`` in the canonical
    :func:`enumerate_points` order, with no Python per-point loop."""
    stop = space.size if stop is None else min(stop, space.size)
    return decode_indices(space, np.arange(start, max(stop, start),
                                           dtype=np.int64))


def sample_genes(space: MapSpace, rng: np.random.Generator, n: int,
                 exclude_flat=None) -> np.ndarray:
    """Up to ``n`` distinct uniform gene rows, deterministic under the
    caller's rng.  Draws flat indices in vectorized batches; only the
    distinctness filter touches a host set (O(n), independent of the
    space size).  ``exclude_flat`` is an iterable of flat indices that
    must not be re-proposed."""
    seen: set[int] = set(int(f) for f in exclude_flat) \
        if exclude_flat is not None else set()
    out: list[int] = []
    drawn = 0
    while len(out) < n and drawn < 20 * n and len(seen) < space.size:
        m = max(2 * (n - len(out)), 64)
        drawn += m
        for f in rng.integers(space.size, size=m).tolist():
            if f in seen:
                continue
            seen.add(f)
            out.append(f)
            if len(out) >= n:
                break
    return decode_indices(space, np.asarray(out, dtype=np.int64))


@dataclasses.dataclass
class GeneTables:
    """Per-(op, space) lookup tables mapping gene columns to everything the
    pipeline needs — built once per space (small Python loops over the
    space *structure*), then applied to arbitrarily large gene matrices by
    pure numpy gathers."""
    # operand encode
    size_tab: np.ndarray          # (A, maxN) f32 tile sizes (padded)
    off_tab: np.ndarray           # (A, maxN) f32 tile offsets
    perm_rank: np.ndarray         # (P, A) f32: axis ai's loop position
    spatial_axis: np.ndarray      # (S,) int64 axis index per spatial choice
    cluster_is_none: np.ndarray   # (C,) bool
    csize_tab: np.ndarray         # (C,) f32 cluster size (0 for None)
    # equivalence signatures
    clamped_tab: np.ndarray       # (A, maxN) int64 min(size, extent)
    trips_tab: np.ndarray         # (A, maxN) int64 non-spatial trip count
    red_axis: np.ndarray          # (A,) bool axis dim is a reduction dim
    inner_masks: tuple            # per dynamic-inner tensor: (A,) bool mask
    out_mask: np.ndarray | None   # (A,) bool output-coupled axes, dynamic
    out_static_rank: float        # rank of output's inner loop when static
    # buffer bounds (KB are derived later; volumes are exact ints)
    vol_static: np.ndarray        # (T,) int64 per-tensor static factor
    vol_tab: np.ndarray           # (T, A, maxN) int64 per-axis factors
    l1_axis_tab: np.ndarray       # (C, T, A, maxN) clamped per-axis factors
    l1_static_tab: np.ndarray     # (C, T) int64 full static factor (L1)


_TABLES: dict[tuple[int, int], tuple[LayerOp, MapSpace, GeneTables]] = {}
_TABLES_MAX = 64   # FIFO bound: a model-zoo sweep must not pin every
#                    (op, space) pair's tables for the process lifetime


def _sizes_env(op: LayerOp, overrides: dict[str, int]) -> dict[str, int]:
    env = dict(op.dims)
    env.update(overrides)
    return env


def gene_tables(op: LayerOp, space: MapSpace) -> GeneTables:
    """Build (and cache) the lookup tables for one (op, space) pair."""
    key = (id(op), id(space))
    hit = _TABLES.get(key)
    if hit is not None and hit[0] is op and hit[1] is space:
        return hit[2]

    a = len(space.axes)
    max_n = max(ax.n for ax in space.axes)
    size_tab = np.zeros((a, max_n), np.float32)
    off_tab = np.ones((a, max_n), np.float32)
    clamped_tab = np.ones((a, max_n), np.int64)
    trips_tab = np.ones((a, max_n), np.int64)
    for ai, ax in enumerate(space.axes):
        ext = op.dims[ax.dim]
        stride = op.stride_of(ax.dim)
        for t in range(ax.n):
            size_tab[ai, t] = ax.sizes[t]
            off_tab[ai, t] = ax.offsets[t]
            clamped_tab[ai, t] = min(ax.sizes[t], ext)
            off = ax.offsets[t] * stride
            trips_tab[ai, t] = 1 + (max(ext - clamped_tab[ai, t], 0)
                                    + off - 1) // off
        for t in range(ax.n, max_n):  # pad with the last real candidate
            size_tab[ai, t] = size_tab[ai, ax.n - 1]
            off_tab[ai, t] = off_tab[ai, ax.n - 1]
            clamped_tab[ai, t] = clamped_tab[ai, ax.n - 1]
            trips_tab[ai, t] = trips_tab[ai, ax.n - 1]

    perm_rank = np.zeros((len(space.perms), a), np.float32)
    for p, perm in enumerate(space.perms):
        for pos, ai in enumerate(perm):
            perm_rank[p, ai] = pos

    spatial_axis = np.asarray(space.spatial_choices, np.int64)
    cluster_is_none = np.asarray(
        [c is None for c in space.cluster_options], bool)
    csize_tab = np.asarray(
        [0.0 if c is None else float(c.size)
         for c in space.cluster_options], np.float32)

    # --- signature statics -------------------------------------------
    axis_dims = [ax.dim for ax in space.axes]
    red = op.reduction_dims()
    red_axis = np.asarray([d in red for d in axis_dims], bool)
    inner_masks = []
    out_mask = None
    out_static_rank = -np.inf  # no coupled loop at all -> no psum spill
    for t in op.tensors():
        coupled_pinned = any(t.coupled_to(d) for d in space.pinned)
        mask = np.asarray([t.coupled_to(d) for d in axis_dims], bool)
        dynamic = not coupled_pinned and mask.any()
        if t is op.output:
            if dynamic:
                out_mask = mask
            elif coupled_pinned or any(
                    t.coupled_to(d) for d in op.dims
                    if d not in axis_dims and d not in space.pinned):
                # inner coupled loop is static: pinned dims sit inside all
                # searched axes (rank >= A), implicit dims outside (rank<0)
                out_static_rank = float(a) if coupled_pinned else -1.0
        if dynamic:
            inner_masks.append(mask)

    # --- buffer-bound volume tables ----------------------------------
    tensors = op.tensors()
    vol_static = np.ones(len(tensors), np.int64)
    vol_tab = np.ones((len(tensors), a, max_n), np.int64)
    n_c = len(space.cluster_options)
    l1_axis_tab = np.zeros((n_c, len(tensors), a, max_n), np.int64)
    l1_static_tab = np.ones((n_c, len(tensors)), np.int64)
    axis_of = {ax.dim: ai for ai, ax in enumerate(space.axes)}
    for ti, t in enumerate(tensors):
        if not t.has_data:
            vol_static[ti] = 0
        for e in t.entries:
            searched = [d for d in e.dims if d in axis_of]
            if not searched:
                vol_static[ti] *= e.extent(op.dims)
                continue
            (d,) = searched  # window dims are pinned, never searched
            ai = axis_of[d]
            for tt in range(max_n):
                env = _sizes_env(op, {d: int(clamped_tab[ai, tt])})
                vol_tab[ti, ai, tt] *= e.extent(env)
    for ci, copt in enumerate(space.cluster_options):
        if copt is None:
            l1_axis_tab[ci] = vol_tab
            l1_static_tab[ci] = vol_static
            continue
        dc = copt.inner_dim
        m0 = min(_resolve_sz(copt.inner_size, op), op.dims[dc])
        for ti, t in enumerate(tensors):
            l1_axis_tab[ci, ti] = vol_tab[ti]
            # static factor recomputed outright (never a truncating ratio)
            static = 0 if not t.has_data else 1
            for e in t.entries:
                searched = [d for d in e.dims if d in axis_of]
                if not searched:
                    static *= e.extent(_sizes_env(op, {dc: m0})) \
                        if dc in e.dims else e.extent(op.dims)
                elif dc in e.dims:
                    # searched-axis factor with the cluster-inner clamp:
                    # divide this entry's base extent out (exact — the
                    # table is a product of entry extents), multiply the
                    # clamped one in
                    ai = axis_of[searched[0]]
                    for tt in range(max_n):
                        env = {searched[0]: int(clamped_tab[ai, tt])}
                        base = e.extent(_sizes_env(op, env))
                        env[dc] = min(m0, env.get(dc, op.dims[dc]))
                        new = e.extent(_sizes_env(op, env))
                        cur = l1_axis_tab[ci, ti, ai, tt]
                        l1_axis_tab[ci, ti, ai, tt] = \
                            cur // max(base, 1) * new
            l1_static_tab[ci, ti] = static

    tables = GeneTables(
        size_tab=size_tab, off_tab=off_tab, perm_rank=perm_rank,
        spatial_axis=spatial_axis, cluster_is_none=cluster_is_none,
        csize_tab=csize_tab, clamped_tab=clamped_tab, trips_tab=trips_tab,
        red_axis=red_axis, inner_masks=tuple(inner_masks),
        out_mask=out_mask, out_static_rank=out_static_rank,
        vol_static=vol_static, vol_tab=vol_tab, l1_axis_tab=l1_axis_tab,
        l1_static_tab=l1_static_tab)
    while len(_TABLES) >= _TABLES_MAX:
        _TABLES.pop(next(iter(_TABLES)))
    _TABLES[key] = (op, space, tables)
    return tables


def _gene_multi_rank(op: LayerOp, space: MapSpace, genes: np.ndarray
                     ) -> tuple[np.ndarray, np.ndarray]:
    """(multi-trip mask, loop rank) per searched axis for each gene row —
    the per-point ingredients of the equivalence signature."""
    tb = gene_tables(op, space)
    n, a = genes.shape[0], len(space.axes)
    tiles = genes[:, 3:]
    rank = tb.perm_rank[genes[:, 1]].astype(np.int64)       # (n, A)
    trips = tb.trips_tab[np.arange(a)[None, :], tiles]      # (n, A)
    multi = trips > 1
    # the spatial axis folds over an unknown PE count: always multi-trip
    sp_axis = tb.spatial_axis[genes[:, 0]]                  # (n,)
    multi[np.arange(n), sp_axis] = True
    return multi, rank


def gene_signatures(op: LayerOp, space: MapSpace, genes: np.ndarray
                    ) -> np.ndarray:
    """Vectorized :func:`canonical_signature`: an (n, S) int64 matrix whose
    rows are equal exactly when the legacy per-point signatures are equal
    (see the partition-parity test)."""
    tb = gene_tables(op, space)
    genes = np.asarray(genes, np.int64)
    n, a = genes.shape[0], len(space.axes)
    multi, rank = _gene_multi_rank(op, space, genes)
    # relative order of the multi-trip axes (== perm_order up to bijection)
    relorder = np.sum(multi[:, None, :]
                      & (rank[:, None, :] < rank[:, :, None]), axis=2)
    relorder = np.where(multi, relorder, -1)                # (n, A)
    cols = [genes[:, 0:1], genes[:, 2:3], genes[:, 3:], relorder]
    # innermost coupled loop per tensor (only dynamic tensors vary)
    for mask in tb.inner_masks:
        masked = np.where(mask[None, :], rank, np.int64(-10 ** 9))
        cols.append(np.argmax(masked, axis=1)[:, None])
    # psum-spill flags: reduction axes outer to the output's inner loop
    if tb.out_mask is not None:
        masked = np.where(tb.out_mask[None, :], rank, np.int64(-10 ** 9))
        rank_o = np.max(masked, axis=1).astype(np.float64)
    else:
        rank_o = np.full(n, tb.out_static_rank)
    red_bits = (tb.red_axis[None, :] & multi
                & (rank < rank_o[:, None])).astype(np.int64)
    cols.append(red_bits)
    return np.concatenate(cols, axis=1)


def dedupe_equivalent_genes(op: LayerOp, space: MapSpace,
                            genes: np.ndarray
                            ) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized analysis-equivalence dedupe over a gene matrix.

    Returns ``(rep_rows, back)``: ``rep_rows`` indexes the first-occurrence
    representative rows (in input order, like the legacy scalar loop) and
    ``back[i]`` maps row ``i`` onto its representative's position."""
    sig = gene_signatures(op, space, genes)
    _, first, inv = np.unique(sig, axis=0, return_index=True,
                              return_inverse=True)
    order = np.argsort(first, kind="stable")
    pos = np.empty(len(order), np.int64)
    pos[order] = np.arange(len(order))
    return first[order], pos[inv.ravel()]


def buffer_estimates_genes(op: LayerOp, space: MapSpace,
                           genes: np.ndarray, dtype_bytes: int = 2
                           ) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized :func:`buffer_estimate_kb` over a gene matrix: per-row
    (L1, L2) working-set lower bounds in KB, bit-identical to the scalar
    loop (exact integer volumes, same float conversion)."""
    tb = gene_tables(op, space)
    genes = np.asarray(genes, np.int64)
    n, a = genes.shape[0], len(space.axes)
    tiles = genes[:, 3:]
    ar = np.arange(a)[None, :]
    l2_vol = np.zeros(n, np.int64)
    l1_vol = np.zeros(n, np.int64)
    c_idx = genes[:, 2]
    for ti in range(len(op.tensors())):
        factors = tb.vol_tab[ti][ar, tiles]                 # (n, A)
        l2_vol += tb.vol_static[ti] * np.prod(factors, axis=1)
        # gather per-row cluster replacement tables: (n, A)
        l1_factors = tb.l1_axis_tab[c_idx[:, None], ti, ar, tiles]
        l1_vol += tb.l1_static_tab[c_idx, ti] * np.prod(l1_factors, axis=1)
    scale = 2 * dtype_bytes / 1024.0
    return l1_vol * scale, l2_vol * scale


def prune_genes_by_budget(op: LayerOp, space: MapSpace, genes: np.ndarray,
                          *, l1_kb: float | None = None,
                          l2_kb: float | None = None,
                          dtype_bytes: int = 2) -> np.ndarray:
    """Vectorized :func:`prune_by_budget`: returns the kept rows."""
    if l1_kb is None and l2_kb is None:
        return np.asarray(genes, np.int64)
    e1, e2 = buffer_estimates_genes(op, space, genes, dtype_bytes)
    keep = np.ones(len(e1), bool)
    if l1_kb is not None:
        keep &= e1 <= l1_kb
    if l2_kb is not None:
        keep &= e2 <= l2_kb
    return np.asarray(genes, np.int64)[keep]


# ----------------------------------------------------------------------
# Enumeration / sampling
# ----------------------------------------------------------------------

def enumerate_points(space: MapSpace) -> Iterator[Point]:
    """All points, grouped (structural genes outermost) so consumers hit
    each jit group exactly once."""
    for s, p, c in space.group_keys():
        for tiles in itertools.product(*[range(ax.n) for ax in space.axes]):
            yield (s, p, c) + tiles


def sample_points(space: MapSpace, rng: np.random.Generator, n: int,
                  group_keys: Sequence[GroupKey] | None = None,
                  exclude: set[Point] | None = None) -> list[Point]:
    """Up to ``n`` distinct uniform points (optionally restricted to a group
    subset), deterministic under the caller's rng."""
    keys = list(group_keys) if group_keys is not None \
        else space.group_keys()
    out: list[Point] = []
    seen = set(exclude) if exclude else set()
    tiles_per_group = 1
    for ax in space.axes:
        tiles_per_group *= ax.n
    limit = len(keys) * tiles_per_group
    attempts = 0
    while len(out) < n and attempts < 20 * n and len(seen) < limit + \
            (len(exclude) if exclude else 0):
        attempts += 1
        key = keys[int(rng.integers(len(keys)))]
        tiles = tuple(int(rng.integers(ax.n)) for ax in space.axes)
        pt = key + tiles
        if pt in seen:
            continue
        seen.add(pt)
        out.append(pt)
    return out
