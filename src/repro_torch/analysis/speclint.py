"""Static legality analysis of dataflow programs and Query specs (the
port's copy of ``repro.analysis.speclint``, over the port's own
``core.directives``, ``core.dataflows``, ``core.tensor_analysis`` and
``mapspace.space``: the same findings for the same inputs).

MAESTRO's core claim is that a directive program can be *analyzed* —
legality, reuse, cost — without running anything.  This linter applies
the cheap half of that claim at the system boundaries: Table-3-style
directive programs and declarative ``Query`` specs are checked for
static legality BEFORE any device work, so an illegal spec is a
one-line structured answer instead of a burned flush slot (the serving
tier runs :func:`lint_query` pre-admission at ``POST /query``).

Checks (all numpy/stdlib — no tensor is built):

* ``SPEC-PARSE``/``SPEC-ILLEGAL`` — structural validation + size/offset
  legality via ``core.directives`` (``validate``/``is_legal``);
* ``SPEC-TILE`` — a *steady* temporal tile (offset == size, i.e. a
  disjoint tiling, not a sliding window) that does not divide its dim's
  extent produces edge phases and knocks the program off the
  divisor-exact universal fast path;
* ``SPEC-CLUSTER`` — empty inner cluster level, or a cluster size
  exceeding the PE array when the hardware point is known;
* ``SPEC-SPATIAL`` — multiple SpatialMaps at one level must be
  *aligned* (equal sizes — Table 3 YR-P's Y/R diagonal);
* ``SPEC-DIMS``/``SPEC-SPACE`` — the query's searched dims must induce
  a non-empty legal mapping space for every resolved layer;
* ``SPEC-BUDGET`` — the analytic working-set LOWER bound of the
  smallest mapping in the space (``mapspace.space.buffer_estimate_kb``
  at minimum tiles) already exceeds the configured L1/L2 prune budget:
  the search is statically infeasible and every candidate would be
  pruned.

``check_query`` surfaces error findings through the ``SpecError`` path
of the error taxonomy, so CLI/API callers get the familiar one-line
exit-2 behaviour with the findings attached as structured detail.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Iterable, Mapping

from ..core import dataflows as _df
from ..core import directives as _d
from ..core.directives import (Cluster, Dataflow, DataflowError,
                               SpatialMap, TemporalMap)
from ..core.tensor_analysis import LayerOp, conv1d_outputs, conv2d
from .findings import Finding

if TYPE_CHECKING:                     # annotation-only: no api import cost
    from ..api.spec import Query


# ----------------------------------------------------------------------
# Dataflow programs
# ----------------------------------------------------------------------

def _levels(df: Dataflow) -> list[tuple[Cluster | None, list]]:
    """Split a directive program at Cluster boundaries:
    [(cluster_or_None, [maps...]), ...] outermost first."""
    out: list[tuple[Cluster | None, list]] = [(None, [])]
    for d in df.directives:
        if isinstance(d, Cluster):
            out.append((d, []))
        else:
            out[-1][1].append(d)
    return out


def lint_dataflow(df: Dataflow, op: LayerOp | Mapping[str, int], *,
                  num_pes: int | None = None,
                  site: str | None = None) -> list[Finding]:
    """Static legality findings for one directive program against one
    layer's dims.  Empty list == legal (and fast-path friendly)."""
    dims = dict(op if isinstance(op, Mapping) else op.dims)
    site = site or f"dataflow::{df.name}"
    findings: list[Finding] = []

    try:
        _d.validate(df.directives)
        ext = _d.extended_dims(df, dims)
        res = _d.resolve(df, ext)
    except DataflowError as e:
        return [Finding(code="SPEC-PARSE", site=site, analyzer="speclint",
                        message=str(e))]

    if not _d.is_legal(res, dims):
        findings.append(Finding(
            code="SPEC-ILLEGAL", site=site, analyzer="speclint",
            message="a directive size/offset is non-positive or larger "
                    "than its (extended) dim extent"))
    # the RAW program, pre-clamp: a static span exceeding the dim's
    # extent is the paper's asterisk case — resolve() silently clamps
    # it to fully-unrolled, which is rarely what the author meant
    for m in df.directives:
        if isinstance(m, Cluster):
            continue
        extent = ext.get(m.dim, 1)
        for what, v in (("size", m.size), ("offset", m.offset)):
            if _d.is_static_size(v) and v != _d.FULL and v > extent:
                findings.append(Finding(
                    code="SPEC-ILLEGAL", site=site, analyzer="speclint",
                    severity="warn",
                    message=f"{type(m).__name__} {what} {v} exceeds "
                            f"dim {m.dim} extent {extent}: resolve() "
                            f"clamps it to a fully-unrolled map"))

    for cl, maps in _levels(res):
        if cl is not None:
            csize = cl.size
            if not maps:
                findings.append(Finding(
                    code="SPEC-CLUSTER", site=site, analyzer="speclint",
                    message=f"Cluster({csize}) with an empty inner "
                            f"level — nothing is mapped inside the "
                            f"cluster"))
            if num_pes is not None and _d.is_static_size(csize) \
                    and csize > num_pes:
                findings.append(Finding(
                    code="SPEC-CLUSTER", site=site, analyzer="speclint",
                    message=f"Cluster({csize}) exceeds the PE array "
                            f"({num_pes} PEs): at most one degenerate "
                            f"cluster fits"))
        spatial = [m for m in maps if isinstance(m, SpatialMap)]
        if len(spatial) > 1:
            sizes = {m.size for m in spatial
                     if _d.is_static_size(m.size)}
            if len(sizes) > 1:
                findings.append(Finding(
                    code="SPEC-SPATIAL", site=site, analyzer="speclint",
                    message=f"{len(spatial)} SpatialMaps at one level "
                            f"with unequal sizes {sorted(sizes)} — "
                            f"aligned distribution needs equal spans"))
        for m in maps:
            if not isinstance(m, TemporalMap):
                continue          # spatial edges are modelled exactly
            if not (_d.is_static_size(m.size)
                    and _d.is_static_size(m.offset)):
                continue
            if m.size != m.offset:
                continue          # sliding window: recompute by design
            extent = ext.get(m.dim, 1)
            if m.size < extent and extent % m.size:
                findings.append(Finding(
                    code="SPEC-TILE", site=site, analyzer="speclint",
                    severity="warn",
                    message=f"TemporalMap({m.size},{m.offset}) {m.dim} "
                            f"does not divide extent {extent}: edge "
                            f"phases put the program on the slow "
                            f"(grouped) path"))
    return findings


def lint_text(text: str, op: LayerOp | Mapping[str, int], *,
              num_pes: int | None = None,
              site: str = "dataflow::<text>") -> list[Finding]:
    """Lint a user-authored textual directive program (the paper's
    syntax, via ``directives.parse``).  A syntax or structural error is
    a ``SPEC-PARSE`` finding instead of an exception — this is the
    front door for the ROADMAP user-authored-dataflow item."""
    try:
        df = _d.parse(text)
    except DataflowError as e:
        return [Finding(code="SPEC-PARSE", site=site, analyzer="speclint",
                        message=str(e))]
    return lint_dataflow(df, op, num_pes=num_pes, site=site)


# ----------------------------------------------------------------------
# Shipped corpus: the paper's programs must stay clean
# ----------------------------------------------------------------------

def _reference_ops() -> dict[str, LayerOp]:
    """Reference layers the shipped corpus is linted against: a VGG-ish
    conv for the Table-3 styles, the paper's Fig. 4/5 1-D conv for the
    pedagogical programs."""
    return {
        "conv": conv2d("lint-conv", k=64, c=64, y=28, x=28, r=3, s=3),
        "conv1d": conv1d_outputs("lint-conv1d", x_out=18, s=3),
    }


def lint_corpus() -> list[Finding]:
    """Lint every shipped dataflow program (Table 3, Fig. 4/5, the
    6-PE row-stationary example) against its reference layer.  The
    zero-findings CI gate runs this: the paper's own programs must
    never trip the linter."""
    ops = _reference_ops()
    findings: list[Finding] = []
    for name in _df.TABLE3:
        df = _df.table3_for_layer(name, ops["conv"])
        findings += lint_dataflow(df, ops["conv"],
                                  site=f"core/dataflows.py::{name}")
    for key, df in _df.FIG5.items():
        findings += lint_dataflow(df, ops["conv1d"],
                                  site=f"core/dataflows.py::FIG5_{key}")
    findings += lint_dataflow(_df.FIG4, ops["conv1d"],
                              site="core/dataflows.py::FIG4")
    findings += lint_dataflow(_df.ROW_STATIONARY_6PE, ops["conv"],
                              site="core/dataflows.py::"
                                   "ROW_STATIONARY_6PE")
    return findings


# ----------------------------------------------------------------------
# Query specs (the serving tier's pre-admission lint)
# ----------------------------------------------------------------------

def _min_point(space) -> tuple:
    """The gene point with the smallest working set: minimum tile on
    every axis, no cluster (tile_candidates sorts ascending)."""
    return (0, 0, 0) + (0,) * len(space.axes)


def _lint_layer(op: LayerOp, q: "Query", site: str) -> list[Finding]:
    # numpy-only: build_space/buffer_estimate_kb build no tensor
    from ..mapspace.space import (MapSpaceError, build_space,
                                  buffer_estimate_kb)
    spec = q.search
    findings: list[Finding] = []
    if spec.dims:
        bad = [d for d in spec.dims if d not in op.dims]
        if bad:
            findings.append(Finding(
                code="SPEC-DIMS", site=site, analyzer="speclint",
                message=f"searched dims {bad} are not dims of "
                        f"{op.name} (has {sorted(op.dims)})"))
            return findings
    try:
        space = build_space(op, dims=spec.dims, cluster=spec.cluster)
    except MapSpaceError as e:
        findings.append(Finding(
            code="SPEC-SPACE", site=site, analyzer="speclint",
            message=str(e)))
        return findings

    num_pes = q.hardware.num_pes
    for copt in space.cluster_options:
        if copt is not None and copt.size > num_pes:
            findings.append(Finding(
                code="SPEC-CLUSTER", site=site, analyzer="speclint",
                severity="warn",
                message=f"cluster option size {copt.size} > "
                        f"{num_pes} PEs: clamps to one degenerate "
                        f"cluster at evaluation time"))

    l1_budget = spec.l1_prune_kb
    l2_budget = spec.l2_prune_kb
    if l1_budget is not None or l2_budget is not None:
        e1, e2 = buffer_estimate_kb(op, space, _min_point(space))
        if l1_budget is not None and e1 > l1_budget:
            findings.append(Finding(
                code="SPEC-BUDGET", site=site, analyzer="speclint",
                message=f"l1_prune_kb={l1_budget}: even the smallest "
                        f"mapping needs >= {e1:.1f} KB of L1 — every "
                        f"candidate would be pruned"))
        if l2_budget is not None and e2 > l2_budget:
            findings.append(Finding(
                code="SPEC-BUDGET", site=site, analyzer="speclint",
                message=f"l2_prune_kb={l2_budget}: even the smallest "
                        f"mapping needs >= {e2:.1f} KB of L2 — every "
                        f"candidate would be pruned"))
    return findings


def lint_query(q: "Query") -> list[Finding]:
    """Static findings for one declarative query: searched-dim
    validity, space constructibility, cluster-vs-PE sanity, and the
    analytic buffer-budget feasibility bound — per resolved layer, all
    before any device work.  ``Query.__post_init__`` has already enforced
    field-level validity; this is the cross-field/workload layer."""
    site_base = f"query::{q.tag or q.workload.describe().get('model') or 'layer'}"
    findings: list[Finding] = []
    try:
        ops = q.workload.resolve()
    except Exception:
        return findings            # resolution errors surface as SpecError
    seen: set[tuple] = set()
    for op in ops:
        shape = (op.op_type, tuple(sorted(op.dims.items())))
        if shape in seen:
            continue               # one lint per unique layer shape
        seen.add(shape)
        findings += _lint_layer(op, q, f"{site_base}::{op.name}")
    return findings


def check_query(q: "Query") -> None:
    """Raise a one-line :class:`SpecError` when the query has
    error-severity findings (the taxonomy's path: CLI exits 2, the
    server answers 400 — both with the findings attached)."""
    errs = [f for f in lint_query(q) if f.severity == "error"]
    if errs:
        from ..resilience.errors import SpecError
        raise SpecError(
            f"query fails static lint: {errs[0].message}"
            + (f" (+{len(errs) - 1} more)" if len(errs) > 1 else ""),
            field=errs[0].code,
            findings=[f.to_json() for f in errs])


def errors_only(findings: Iterable[Finding]) -> list[Finding]:
    return [f for f in findings if f.severity == "error"]
