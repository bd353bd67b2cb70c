"""The unified :class:`Report` result schema of the declarative front
door — the port of ``repro.api.report``, with the same JSON, so that a
port report diffs field by field with a reference report (provenance and
``timing`` aside).

Every engine behind :class:`repro_torch.api.Session` — per-layer mapping
search, joint co-DSE, whole-network schedule search, the coalesced
``run_many`` pass — answers in the SAME shape: a best design, a top-k
list, an optional Pareto frontier, and one set of counters/rates.
``to_json()``/``from_json()`` round-trip exactly, and benchmark payloads
are emitted through the same schema (``Report.bench``).
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Any

from .spec import SCHEMA_VERSION, Query

if TYPE_CHECKING:
    import torch

# Field names reserved by the flat JSON form (everything else in a
# payload round-trips through ``extras``).
_RESERVED = ("schema_version", "kind", "name", "objective", "strategy",
             "query", "tag", "best", "top_k", "pareto", "n_evaluated",
             "n_compiles", "compile_s", "eval_s", "encode_s",
             "elapsed_s", "n_devices", "coalesced", "rates")


def _jsonable(v: Any) -> Any:
    """numpy scalars/arrays -> Python scalars/lists, tuples -> lists."""
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if hasattr(v, "item") and not hasattr(v, "__len__"):
        return v.item()
    if hasattr(v, "tolist"):
        return v.tolist()
    return v


@dataclasses.dataclass
class Report:
    """One query's answer (or one benchmark's payload) in the unified
    schema.  ``raw`` keeps the engine-native result object for callers
    that need the full dataclass (never serialized)."""
    kind: str                          # layer | layer_codse | network |
    #                                    network_codse | bench | error
    name: str = ""                     # workload / bench label
    objective: str = ""
    strategy: str = ""
    query: dict[str, Any] | None = None
    tag: str | None = None
    best: dict[str, Any] = dataclasses.field(default_factory=dict)
    top_k: list[dict[str, Any]] = dataclasses.field(default_factory=list)
    pareto: list[dict[str, Any]] = dataclasses.field(default_factory=list)
    n_evaluated: int = 0
    n_compiles: int = 0
    compile_s: float = 0.0
    eval_s: float = 0.0
    encode_s: float = 0.0
    elapsed_s: float = 0.0
    n_devices: int = 1
    coalesced: bool = False            # answered by a shared device pass
    rates: dict[str, float] = dataclasses.field(default_factory=dict)
    extras: dict[str, Any] = dataclasses.field(default_factory=dict)
    raw: Any = None

    # ------------------------------------------------------------------
    # JSON round trip
    # ------------------------------------------------------------------

    def to_json(self) -> dict[str, Any]:
        """Flat JSON dict: the reserved schema fields plus ``extras``
        merged at top level (benchmark payload keys stay where CI and
        the perf tracker have always read them)."""
        d: dict[str, Any] = {"schema_version": SCHEMA_VERSION}
        for f in _RESERVED[1:]:
            d[f] = _jsonable(getattr(self, f))
        clash = set(self.extras) & set(_RESERVED)
        if clash:
            raise ValueError(f"extras collide with schema fields: "
                             f"{sorted(clash)}")
        d.update(_jsonable(self.extras))
        return d

    @staticmethod
    def from_json(d: dict[str, Any]) -> "Report":
        """Inverse of :meth:`to_json`, tolerant of *newer* payloads:
        unknown top-level fields ride along in ``extras`` (a v(N) client
        can read a v(N+x) server's report during a rolling upgrade), but
        a ``schema_version`` mismatch — result semantics may differ — is
        a one-line :class:`SpecError` naming both versions."""
        from ..resilience.errors import SpecError
        d = dict(d)
        ver = d.pop("schema_version", SCHEMA_VERSION)
        if ver != SCHEMA_VERSION:
            raise SpecError(
                f"report schema_version {ver} != supported "
                f"{SCHEMA_VERSION}", field="schema_version")
        kw = {f: d.pop(f) for f in _RESERVED[1:] if f in d}
        return Report(**kw, extras=d)

    def results_json(self) -> dict[str, Any]:
        """The DETERMINISTIC slice of the report — what two runs of the
        same query must agree on bit-for-bit (no timings, no rates)."""
        return {k: _jsonable(getattr(self, k))
                for k in ("kind", "name", "objective", "strategy",
                          "best", "top_k", "pareto", "n_evaluated")}

    # ------------------------------------------------------------------
    # Constructors from the engine result dataclasses
    # ------------------------------------------------------------------

    @staticmethod
    def bench(name: str, payload: dict[str, Any], *,
              device: "str | torch.device | None" = None) -> "Report":
        """Wrap a benchmark payload: keys matching schema fields land on
        the report itself, the rest ride in ``extras`` — the flat JSON
        keeps every historical BENCH_* key at top level.

        Every bench artifact carries an ``environment`` provenance block
        (torch/CUDA versions, backend, device kind/count, host, git SHA)
        of the device the benchmark ran on (``cuda`` unless ``device``
        names another) so its numbers are comparable across machines;
        pass an explicit ``environment`` key to override."""
        from .. import obs
        payload = dict(payload)
        if "environment" not in payload:
            payload["environment"] = obs.environment(device)
        kw = {f: payload.pop(f) for f in _RESERVED[3:] if f in payload}
        return Report(kind="bench", name=name, **kw, extras=payload)

    @staticmethod
    def from_error(query: Query, err: BaseException) -> "Report":
        """An isolated failure in a batch: ``run_many`` degrades a
        poisoned coalesced pass to per-query execution and answers the
        queries that still fail with an ``error``-kind report instead of
        poisoning the whole batch."""
        msg = str(err).strip().splitlines()[0] if str(err).strip() else ""
        return Report(
            kind="error", objective=query.search.objective,
            query=query.describe(), tag=query.tag,
            extras={"error": {"type": type(err).__name__,
                              "message": msg,
                              "details": _jsonable(
                                  getattr(err, "details", {}))}})

    @staticmethod
    def timeout(query: Query, *, deadline_s: float | None,
                waited_s: float, where: str = "queued") -> "Report":
        """A deadline-expired request's terminal answer: ``extras
        ["timeout"]`` marks the report as partial (no best/top_k), with
        the budget that expired and where the request was when it did."""
        from .. import obs
        obs.flight_record("event", "timeout-report", where=where,
                          deadline_s=deadline_s,
                          waited_s=round(float(waited_s), 4))
        return Report(
            kind="timeout", objective=query.search.objective,
            query=query.describe(), tag=query.tag,
            elapsed_s=float(waited_s),
            extras={"timeout": {"deadline_s": deadline_s,
                                "waited_s": round(float(waited_s), 4),
                                "where": where}})

    @staticmethod
    def from_search(r, query: Query | None = None) -> "Report":
        """From :class:`repro_torch.mapspace.search.SearchResult`."""
        return Report(
            kind="layer", name=getattr(r.space, "op_name", "") or "",
            objective=r.objective, strategy=r.strategy,
            query=query.describe() if query else None,
            tag=query.tag if query else None,
            best={"point": list(r.best_point), "value": float(r.best_value),
                  "stats": _jsonable(r.best_stats)},
            top_k=[{"point": list(e["point"]), "value": float(e["value"]),
                    "stats": _jsonable(e["stats"])} for e in r.top_k],
            n_evaluated=int(r.n_evaluated), n_compiles=int(r.n_compiles),
            compile_s=float(r.compile_s), eval_s=float(r.eval_s),
            encode_s=float(r.encode_s), elapsed_s=float(r.elapsed_s),
            n_devices=int(r.n_devices),
            rates={"mappings_per_s": float(r.mappings_per_s),
                   "end_to_end_mappings_per_s":
                       float(r.end_to_end_mappings_per_s)},
            extras={"cached": bool(r.cached), "pipeline": r.pipeline,
                    "n_groups": int(r.n_groups)},
            raw=r)

    @staticmethod
    def from_codse(co, query: Query | None = None) -> "Report":
        """From :class:`repro_torch.mapspace.codse.CoDSEResult`."""
        rep = Report.from_search(co.search, query)
        rep.kind = "layer_codse"
        rep.pareto = _jsonable(co.pareto)
        rep.best = {"per_objective": _jsonable(co.best),
                    "mapping": rep.best}
        rep.n_evaluated = int(co.n_evaluated)
        rep.n_compiles = int(co.n_compiles)
        rep.elapsed_s = float(co.elapsed_s)
        if co.joint is not None:
            rep.extras["joint"] = {
                "n_designs": int(co.joint.n_designs),
                "n_hw": int(co.joint.n_hw),
                "n_valid": int(co.joint.n_valid),
                "designs_per_s": float(co.joint.designs_per_s),
                "top": _jsonable(co.joint.top[:4]),
            }
        rep.raw = co
        return rep

    @staticmethod
    def from_network(r, query: Query | None = None) -> "Report":
        """From :class:`repro_torch.netspace.search.NetSearchResult`."""
        s = r.schedule
        return Report(
            kind="network", objective=r.objective, strategy=r.strategy,
            query=query.describe() if query else None,
            tag=query.tag if query else None,
            best={"cost": float(s.cost), "runtime": float(s.runtime),
                  "energy_pj": float(s.energy_pj),
                  "edp": float(s.network_edp),
                  "throughput": float(s.throughput),
                  "segments": _jsonable(s.segments),
                  "n_reconfigs": int(s.n_reconfigs),
                  "per_layer": _jsonable(s.per_layer)},
            n_evaluated=int(r.n_evaluated), n_compiles=int(r.n_compiles),
            compile_s=float(r.compile_s), eval_s=float(r.eval_s),
            encode_s=float(r.encode_s), elapsed_s=float(r.elapsed_s),
            n_devices=int(r.n_devices),
            rates={"schedules_per_s": float(r.schedules_per_s)},
            extras={"composer": r.composer, "n_layers": int(r.n_layers),
                    "n_unique": int(r.n_unique),
                    "n_classes": int(r.n_classes),
                    "budget_policy": getattr(r, "budget_policy",
                                             "uniform"),
                    "refined": _jsonable(getattr(r, "refined", []))},
            raw=r)

    @staticmethod
    def from_conet(co, query: Query | None = None) -> "Report":
        """From :class:`repro_torch.netspace.search.CoNetResult`."""
        rep = Report.from_network(co.search, query)
        rep.kind = "network_codse"
        rep.pareto = _jsonable(co.pareto)
        rep.best = {"per_objective": _jsonable(co.best),
                    "schedule": rep.best}
        rep.top_k = _jsonable(co.top)
        rep.n_evaluated = int(co.n_designs)
        rep.n_compiles = int(co.n_compiles)
        rep.elapsed_s = float(co.elapsed_s)
        rep.extras.update({"n_hw": int(co.n_hw),
                           "n_valid": int(co.n_valid)})
        rep.raw = co
        return rep
