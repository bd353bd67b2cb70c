"""Network-level mapping space: ONE gene layout per op-class — the port of
``repro.netspace.space`` (numpy, no device work).

``repro_torch.mapspace`` defines the per-layer space; a network search
needs the same *kind* of space for every layer while each layer keeps its
own legal tile candidates.  This module groups a network's
(shape-deduplicated) layers into **op-classes** — layers sharing dim
universe, window/pinned structure and conv strides — and builds, per
class:

  * per-layer :class:`~repro_torch.mapspace.space.MapSpace` instances with
    IDENTICAL ``gene_ranges()``: the same searched axes, permutations,
    spatial choices and cluster-option slots, with tile axes padded to a
    common candidate count (``pad_tile_axes``) so one ``(n, G)`` gene
    matrix layout covers every layer of the class;
  * a pair of :class:`UniversalSpec` evaluators with ``ext_operand=True``
    — layer shape is an operand column, so ONE evaluator per (op-class,
    level-count) evaluates candidate frontiers for every layer of
    VGG16/ResNet50/MobileNetV2 in a single device pass.

Cluster options are planned at class level (uniform slot count; per-layer
sizes clamp to the layer's useful extent exactly like ``build_space``) so
the cluster gene means the same thing for every member layer.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from ..core.directives import Sz
from ..core.dnn_models import unique_layers
from ..core.tensor_analysis import ConvExpr, LayerOp
from ..core.vectorized import UniversalSpec
from ..mapspace.space import (ClusterOption, MapSpace, build_space,
                              pad_tile_axes, _resolve_sz)


@dataclasses.dataclass
class NetClass:
    """One op-class: layers evaluable by a single shape-as-operand
    evaluator pair."""
    key: tuple
    rep: LayerOp                      # representative (the evaluators
    #                                   close over it; see evaluator.py)
    dims: tuple[str, ...]             # searched axis dims (shared)
    spec1: UniversalSpec
    spec2: UniversalSpec | None
    cluster_dims: tuple[str, ...]     # spec2 one-hot candidate inner dims
    members: list[int]                # unique-layer ids in this class


@dataclasses.dataclass
class NetSpace:
    """The whole-network search space: per-unique-layer padded spaces plus
    the op-class partition that drives compilation."""
    layers: list[LayerOp]             # full network, schedule order
    index: list[int]                  # layer position -> unique id
    unique: list[LayerOp]             # shape-deduplicated layers
    spaces: list[MapSpace]            # per unique id (padded, shared ranges)
    class_of: list[int]               # unique id -> class id
    classes: list[NetClass]
    fusible: list[bool]               # per boundary (i, i+1): output of i
    #                                   consumed only by i+1 (chain edges)

    @property
    def n_layers(self) -> int:
        return len(self.layers)

    def space_for(self, layer_idx: int) -> MapSpace:
        return self.spaces[self.index[layer_idx]]

    def op_for(self, layer_idx: int) -> LayerOp:
        return self.layers[layer_idx]

    def ext_row(self, uid: int) -> np.ndarray:
        """The layer-shape operand row: dim extents in spec dim order."""
        op = self.unique[uid]
        cls = self.classes[self.class_of[uid]]
        return np.asarray([op.dims[d] for d in cls.spec1.dim_names],
                          np.float32)

    def cin_rows(self, uid: int) -> tuple[np.ndarray, np.ndarray]:
        """Per-layer resolved cluster inner (size, offset) operand rows,
        one entry per spec2 candidate dim."""
        op = self.unique[uid]
        space = self.spaces[uid]
        cls = self.classes[self.class_of[uid]]
        size = np.ones(len(cls.cluster_dims), np.float32)
        off = np.ones(len(cls.cluster_dims), np.float32)
        for copt in space.cluster_options:
            if copt is None:
                continue
            k = cls.cluster_dims.index(copt.inner_dim)
            ext = op.dims[copt.inner_dim]
            size[k] = min(_resolve_sz(copt.inner_size, op), ext)
            off[k] = min(_resolve_sz(copt.inner_offset, op), ext)
        return size, off

    def cand_of_option(self, uid: int) -> np.ndarray:
        """cluster-option gene value -> spec2 candidate index (-1 = None)."""
        space = self.spaces[uid]
        cls = self.classes[self.class_of[uid]]
        out = np.full(len(space.cluster_options), -1, np.int64)
        for ci, copt in enumerate(space.cluster_options):
            if copt is not None:
                out[ci] = cls.cluster_dims.index(copt.inner_dim)
        return out


def _class_key(op: LayerOp) -> tuple:
    """Layers with equal keys share directive structure (not extents):
    op type, dim universe, window couplings + strides, weightlessness."""
    entries = []
    for t in op.tensors():
        entries.append((t.name, t.has_data,
                        tuple(sorted(map(str, t.entries)))))
    return (op.op_type, tuple(op.dims),
            tuple(op.stride_of(d) for d in op.dims), tuple(entries))


def _window_outers(op: LayerOp) -> dict[str, tuple[str, int]]:
    return {e.outer: (e.window, e.stride) for e in op.output.entries
            if isinstance(e, ConvExpr)}


def _pinned(op: LayerOp) -> tuple[str, ...]:
    pinned = []
    for t in (op.output, op.input):
        for e in t.entries:
            w = getattr(e, "window", None)
            if w and w in op.dims and w not in pinned:
                pinned.append(w)
    return tuple(pinned)


def build_netspace(layers: Sequence[LayerOp], *,
                   max_tiles_per_dim: int = 6,
                   perm_mode: str = "auto",
                   cluster: bool = True,
                   cluster_sizes: Sequence[int] = (64,),
                   fusible: Sequence[bool] | None = None) -> NetSpace:
    """Build the shared-gene-layout network space for ``layers``.

    ``fusible[i]`` marks the boundary between schedule positions ``i`` and
    ``i+1`` as a legal fusion point (layer ``i``'s output consumed ONLY by
    ``i+1``); default: every boundary (a chain).  Pass an explicit mask for
    graphs with skip edges (ResNet) — the composer never fuses across a
    masked boundary, and the genetic composer handles the rest.
    """
    layers = list(layers)
    unique, index = unique_layers(layers)

    by_class: dict[tuple, list[int]] = {}
    for uid, op in enumerate(unique):
        by_class.setdefault(_class_key(op), []).append(uid)

    classes: list[NetClass] = []
    class_of = [0] * len(unique)
    spaces: list[MapSpace | None] = [None] * len(unique)
    for key, members in by_class.items():
        rep = unique[members[0]]
        pinned = _pinned(rep)
        # searched dims: any member exceeds extent 1 (members at extent 1
        # get the single trivial candidate and ride along)
        dims = tuple(
            d for d in rep.dims
            if d not in pinned and d != "N"
            and any(unique[u].dims[d] > 1 for u in members))
        if not dims:
            dims = tuple(d for d in rep.dims
                         if d not in pinned and d != "N")[:1]
        mode = perm_mode
        if mode == "auto":
            mode = "all" if len(dims) <= 3 else "rotations"

        # class-level cluster plan: same option slots for every member,
        # mirroring build_space's defaults (one searched reduction dim +
        # one sliding-window inner), sizes clamped per layer
        windows = _window_outers(rep)
        inner_dims: list[str] = []
        if cluster:
            red = rep.reduction_dims()
            inner_dims = [d for d in dims if d in red][:1]
            win = [d for d in windows if d in dims]
            inner_dims += [d for d in win[-1:] if d not in inner_dims]
        plan = [(d, int(c)) for d in inner_dims
                for c in dict.fromkeys(int(c) for c in cluster_sizes)]

        member_spaces = []
        for u in members:
            op = unique[u]
            base = build_space(op, dims=dims, perm_mode=mode,
                               max_tiles_per_dim=max_tiles_per_dim,
                               cluster=False)
            options: list[ClusterOption | None] = [None]
            for d, c in plan:
                if d in windows:
                    w, stride = windows[d]
                    useful = (op.dims[d] - op.dims[w]) // stride + 1
                    inner: tuple = (Sz(w), 1)
                else:
                    useful = op.dims[d]
                    inner = (1, 1)
                options.append(ClusterOption(max(min(c, useful), 1), d,
                                             *inner))
            member_spaces.append(dataclasses.replace(
                base, cluster_options=tuple(options)))
        counts = [max(sp.axes[ai].n for sp in member_spaces)
                  for ai in range(len(dims))]
        ranges = None
        for u, sp in zip(members, member_spaces):
            sp = pad_tile_axes(sp, counts)
            spaces[u] = sp
            class_of[u] = len(classes)
            if ranges is None:
                ranges = sp.gene_ranges()
            elif sp.gene_ranges() != ranges:
                raise ValueError(
                    f"class {key}: member gene ranges diverge "
                    f"({sp.gene_ranges()} vs {ranges})")

        cluster_dims = tuple(dict.fromkeys(d for d, _ in plan))
        spec1 = UniversalSpec(dim_names=tuple(rep.dims), axis_dims=dims,
                              pinned=pinned, single_edge=True,
                              ext_operand=True)
        spec2 = UniversalSpec(dim_names=tuple(rep.dims), axis_dims=dims,
                              pinned=pinned,
                              cluster=tuple((d, 0, 0)
                                            for d in cluster_dims),
                              single_edge=True, ext_operand=True) \
            if cluster_dims else None
        classes.append(NetClass(key=key, rep=rep, dims=dims, spec1=spec1,
                                spec2=spec2, cluster_dims=cluster_dims,
                                members=list(members)))

    if fusible is None:
        fusible = [True] * (len(layers) - 1)
    fusible = list(fusible)
    if len(fusible) != max(len(layers) - 1, 0):
        raise ValueError(f"fusible mask needs {len(layers) - 1} entries, "
                         f"got {len(fusible)}")

    return NetSpace(layers=layers, index=index, unique=unique,
                    spaces=[s for s in spaces], class_of=class_of,
                    classes=classes, fusible=fusible)


def halo_fractions(op: LayerOp, space: MapSpace, genes: np.ndarray
                   ) -> np.ndarray:
    """Per-candidate fused-stack recompute fraction, analytically from the
    sliding-window overlap structure the reuse analysis models (RA halo
    class): when this layer is the CONSUMER of a fused boundary, depth-
    first tiling re-produces the window overlap ``(R - stride)`` input
    rows/cols at every interior tile boundary of each tiled window-outer
    axis.  Fraction of the producer's work recomputed =
    ``sum_axes (n_tiles - 1) * overlap / extent``, capped at 1."""
    genes = np.asarray(genes, np.int64)
    windows = _window_outers(op)
    frac = np.zeros(genes.shape[0], np.float64)
    for ai, ax in enumerate(space.axes):
        if ax.dim not in windows:
            continue
        w, stride = windows[ax.dim]
        overlap = op.dims[w] - stride
        if overlap <= 0:
            continue
        ext = op.dims[ax.dim]
        out_ext = (ext - op.dims[w]) // stride + 1
        offs = np.asarray(ax.offsets, np.float64)[genes[:, 3 + ai]]
        n_tiles = np.ceil(out_ext / offs)
        frac += (n_tiles - 1) * overlap / ext
    return np.minimum(frac, 1.0)
