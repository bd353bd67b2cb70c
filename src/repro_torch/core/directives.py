"""Data-centric dataflow directives (the paper's §3 IR).

A dataflow is an ordered sequence of directives:

  * ``SpatialMap(size, offset) dim``  — distribute ``dim`` across sub-clusters
    (PEs at the innermost level); each sub-cluster gets ``size`` consecutive
    indices, consecutive sub-clusters shifted by ``offset``.
  * ``TemporalMap(size, offset) dim`` — distribute ``dim`` across time steps;
    every sub-cluster sees the *same* chunk in a given step.
  * ``Cluster(size)``                 — group sub-clusters: directives above a
    Cluster see logical clusters, directives below see inside one cluster.

Directive *order* is the data-movement order: the innermost (last) map
advances first, odometer-style (paper §3.1, "Data Movement Order").

``size``/``offset`` may be the sentinel :data:`FULL`, meaning "the whole
dimension" (the paper writes ``Sz(R)``); it is resolved against a concrete
layer by :func:`resolve`.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Iterator, Mapping, Sequence, Union

# Sentinel for "size of the mapped dimension itself".
FULL = -1


@dataclasses.dataclass(frozen=True)
class Sz:
    """Symbolic size: the full extent of dimension ``dim`` (the paper's
    ``Sz(R)`` — which frequently refers to a *different* dim than the one
    being mapped, e.g. ``TemporalMap(Sz(R), 1) Y``)."""
    dim: str

    def __str__(self) -> str:
        return f"Sz({self.dim})"


Size = Union[int, Sz]


def is_static_size(v) -> bool:
    """True for plain Python ints (including FULL); False for Sz symbols and
    torch tensors.  Tensor sizes appear when the mapping-space engine
    vectorizes tile sizes (``repro.mapspace``): structural checks that would
    force concretization are skipped for them — legality is enforced upstream
    by the space definition."""
    return isinstance(v, int) and not isinstance(v, bool)


@dataclasses.dataclass(frozen=True)
class TemporalMap:
    size: Size
    offset: Size
    dim: str

    def __str__(self) -> str:
        return f"TemporalMap({_sz(self.size, self.dim)},{_sz(self.offset, self.dim)}) {self.dim}"


@dataclasses.dataclass(frozen=True)
class SpatialMap:
    size: Size
    offset: Size
    dim: str

    def __str__(self) -> str:
        return f"SpatialMap({_sz(self.size, self.dim)},{_sz(self.offset, self.dim)}) {self.dim}"


@dataclasses.dataclass(frozen=True)
class Cluster:
    size: Size

    def __str__(self) -> str:
        return f"Cluster({self.size})"


Directive = Union[TemporalMap, SpatialMap, Cluster]
MapDirective = Union[TemporalMap, SpatialMap]


def _sz(v: Size, dim: str) -> str:
    if isinstance(v, Sz):
        return str(v)
    return f"Sz({dim})" if v == FULL else str(v)


def _resolve_size(v: Size, own_dim: str | None, dims: Mapping[str, int]):
    if isinstance(v, Sz):
        if v.dim not in dims:
            raise DataflowError(f"Sz({v.dim}) refers to unknown dim; "
                                f"layer dims: {sorted(dims)}")
        return dims[v.dim]
    if is_static_size(v) and v == FULL:
        if own_dim is None:
            raise DataflowError("Cluster size cannot be FULL")
        return dims[own_dim]
    return v


def _clamp(v, full):
    """min(v, full) that works for static ints and torch tensors."""
    if is_static_size(v):
        return min(v, full)
    import torch
    return torch.minimum(v, torch.as_tensor(full, dtype=v.dtype,
                                            device=v.device))


@dataclasses.dataclass(frozen=True)
class Dataflow:
    """An ordered directive program plus a human-readable name."""

    name: str
    directives: tuple[Directive, ...]

    def __post_init__(self) -> None:
        validate(self.directives)

    def __iter__(self) -> Iterator[Directive]:
        return iter(self.directives)

    def __str__(self) -> str:
        body = "\n".join(f"  {d}" for d in self.directives)
        return f"Dataflow {self.name} {{\n{body}\n}}"

    # ------------------------------------------------------------------
    @property
    def levels(self) -> tuple[tuple[MapDirective, ...], ...]:
        """Split the program into per-cluster-level map sequences.

        Level 0 is the outermost (above the first Cluster directive).
        """
        out: list[tuple[MapDirective, ...]] = []
        cur: list[MapDirective] = []
        for d in self.directives:
            if isinstance(d, Cluster):
                out.append(tuple(cur))
                cur = []
            else:
                cur.append(d)
        out.append(tuple(cur))
        return tuple(out)

    @property
    def cluster_sizes(self) -> tuple[int, ...]:
        return tuple(d.size for d in self.directives if isinstance(d, Cluster))

    def mapped_dims(self) -> set[str]:
        return {d.dim for d in self.directives if not isinstance(d, Cluster)}

    def spatial_dims(self) -> tuple[str, ...]:
        return tuple(
            d.dim for d in self.directives if isinstance(d, SpatialMap))

    def with_name(self, name: str) -> "Dataflow":
        return Dataflow(name, self.directives)


class DataflowError(ValueError):
    pass


def validate(directives: Sequence[Directive]) -> None:
    """Structural validation (paper constraints).

    * a dim is mapped at most once per cluster level;
    * Cluster sizes are positive;
    * map sizes/offsets are positive (or FULL).

    Multiple SpatialMaps at one level are allowed and mean *aligned*
    distribution — unit ``u`` takes chunk ``u`` of every spatially mapped
    dim simultaneously (the paper's Table 3 YR-P maps Y and R this way,
    which is exactly Eyeriss's diagonal input mapping).
    """
    level = 0
    seen_dims: set[str] = set()

    def _ok(v) -> bool:
        if isinstance(v, Sz) or not is_static_size(v):
            return True  # symbolic / traced — legality enforced upstream
        return v == FULL or v > 0

    for d in directives:
        if isinstance(d, Cluster):
            if is_static_size(d.size) and d.size <= 0:
                raise DataflowError(f"Cluster size must be > 0, got {d.size}")
            level += 1
            seen_dims = set()
            continue
        if not _ok(d.size):
            raise DataflowError(f"map size must be > 0, FULL or Sz: {d}")
        if not _ok(d.offset):
            raise DataflowError(f"map offset must be > 0, FULL or Sz: {d}")
        if d.dim in seen_dims:
            raise DataflowError(
                f"dim {d.dim!r} mapped twice at cluster level {level}")
        seen_dims.add(d.dim)


# ----------------------------------------------------------------------
# Resolution against a concrete layer
# ----------------------------------------------------------------------

def resolve(df: Dataflow, dims: dict[str, int]) -> Dataflow:
    """Replace FULL/Sz sentinels with concrete dimension sizes and clamp map
    sizes to the dimension extent (a map larger than the dim is the same as a
    fully-unrolled map — the paper marks these with an asterisk)."""
    out: list[Directive] = []
    for d in df.directives:
        if isinstance(d, Cluster):
            out.append(Cluster(_resolve_size(d.size, None, dims)))
            continue
        if d.dim not in dims:
            raise DataflowError(
                f"dataflow {df.name!r} maps unknown dim {d.dim!r}; "
                f"layer dims: {sorted(dims)}")
        full = dims[d.dim]
        size = _clamp(_resolve_size(d.size, d.dim, dims), full)
        offset = _clamp(_resolve_size(d.offset, d.dim, dims), full)
        out.append(type(d)(size, offset, d.dim))
    return Dataflow(df.name, tuple(out))


def complete(df: Dataflow, dims: dict[str, int]) -> Dataflow:
    """CLA-engine directive completion (the paper's "augment the given
    dataflow descriptions for missing directives"):

    * any layer dim not mentioned at the outermost level gets an implicit
      fully-unrolled TemporalMap prepended (a single iteration, so its
      position among temporal maps does not change steady-state behaviour);
    * any directive dim the layer does *not* have (e.g. K for a depth-wise
      conv, Y/X/R/S for an FC layer) is kept but resolved against an
      extent-1 dim — modeling the real under-utilization of running such a
      layer on that dataflow (e.g. NVDLA-style K-partitioning wastes PEs on
      depth-wise convolutions).
    """
    dims = dict(dims)
    for d in df.directives:
        for ref in _referenced_dims(d):
            dims.setdefault(ref, 1)
    mentioned = df.mapped_dims()
    missing = [k for k in dims if k not in mentioned]
    extra = tuple(TemporalMap(FULL, FULL, k) for k in missing)
    return resolve(Dataflow(df.name, extra + df.directives), dims)


def extended_dims(df: Dataflow, dims: dict[str, int]) -> dict[str, int]:
    """Layer dims extended with extent-1 entries for every dim the dataflow
    references but the layer lacks (see :func:`complete`)."""
    out = dict(dims)
    for d in df.directives:
        for ref in _referenced_dims(d):
            out.setdefault(ref, 1)
    return out


def _referenced_dims(d: Directive) -> list[str]:
    out = []
    if isinstance(d, Cluster):
        if isinstance(d.size, Sz):
            out.append(d.size.dim)
        return out
    out.append(d.dim)
    for v in (d.size, d.offset):
        if isinstance(v, Sz):
            out.append(v.dim)
    return out


# ----------------------------------------------------------------------
# Parser for the paper's textual syntax
# ----------------------------------------------------------------------

_LINE = re.compile(
    r"^\s*(?P<kind>SpatialMap|TemporalMap|Cluster)\s*"
    r"\(\s*(?P<a>Sz\(\w+\)|\d+)\s*(?:,\s*(?P<b>Sz\(\w+\)|\d+)\s*)?\)\s*"
    r"(?P<dim>\w+)?\s*;?\s*$",
    re.IGNORECASE,
)


def parse(text: str, name: str = "parsed") -> Dataflow:
    """Parse the paper's textual notation, e.g.::

        SpatialMap(1,1) K
        TemporalMap(64,64) C
        TemporalMap(Sz(R),Sz(R)) R
        Cluster(64)
        SpatialMap(1,1) C
    """
    dirs: list[Directive] = []
    for raw in text.strip().splitlines():
        line = raw.strip()
        if not line or line.startswith("#") or line.startswith("//"):
            continue
        m = _LINE.match(line)
        if not m:
            raise DataflowError(f"cannot parse directive line: {raw!r}")
        kind = m.group("kind").lower()
        a = _parse_num(m.group("a"))
        if kind == "cluster":
            dirs.append(Cluster(a))
            continue
        b = _parse_num(m.group("b")) if m.group("b") else a
        dim = m.group("dim")
        if not dim:
            raise DataflowError(f"map directive missing dim: {raw!r}")
        cls = SpatialMap if kind == "spatialmap" else TemporalMap
        dirs.append(cls(a, b, dim.upper()))
    return Dataflow(name, tuple(dirs))


_SZ = re.compile(r"^sz\((\w+)\)$", re.IGNORECASE)


def _parse_num(tok: str) -> Size:
    m = _SZ.match(tok.strip())
    if m:
        return Sz(m.group(1).upper())
    return int(tok)


# ----------------------------------------------------------------------
# Divisor / legality helpers (used by the mapping-space engine)
# ----------------------------------------------------------------------

def divisors(n: int) -> tuple[int, ...]:
    """All positive divisors of ``n`` in ascending order."""
    if n <= 0:
        raise ValueError(f"divisors() needs n > 0, got {n}")
    small, large = [], []
    d = 1
    while d * d <= n:
        if n % d == 0:
            small.append(d)
            if d != n // d:
                large.append(n // d)
        d += 1
    return tuple(small + large[::-1])


def tile_candidates(extent: int, max_candidates: int | None = None
                    ) -> tuple[int, ...]:
    """Candidate tile sizes for a dim of ``extent``: its divisor set, thinned
    evenly (keeping 1 and the full extent) when larger than
    ``max_candidates`` so space sizes stay controllable."""
    divs = divisors(extent)
    if max_candidates is None or len(divs) <= max_candidates or \
            max_candidates < 2:
        return divs
    idx = {0, len(divs) - 1}
    for i in range(1, max_candidates - 1):
        idx.add(round(i * (len(divs) - 1) / (max_candidates - 1)))
    return tuple(divs[i] for i in sorted(idx))


def is_legal(df: Dataflow, dims: Mapping[str, int]) -> bool:
    """Legality of a concrete directive program against layer dims: every
    static map size/offset must be positive and no larger than the (extended)
    extent of its dim.  Symbolic sizes are legal by construction (``resolve``
    clamps them)."""
    ext = dict(dims)
    for d in df.directives:
        for ref in _referenced_dims(d):
            ext.setdefault(ref, 1)
    for d in df.directives:
        if isinstance(d, Cluster):
            if is_static_size(d.size) and d.size <= 0:
                return False
            continue
        for v in (d.size, d.offset):
            if not is_static_size(v) or v == FULL:
                continue
            if v <= 0 or v > ext[d.dim]:
                return False
    return True
