"""Declarative query specs: ``Workload`` x ``Hardware`` x ``SearchSpec``
composed into a :class:`Query` — the port of ``repro.api.spec``, with the
same fields, the same JSON and the same fingerprints.

A query is pure data — no engine state, no device handles — so it can be
hashed (cache keys), serialized (``--file queries.json`` batch mode)
and routed (:meth:`repro_torch.api.Session.run` picks the engine from the
query's shape):

  * ``Workload`` — ONE layer, an explicit layer list, or a named zoo
    network;
  * ``Hardware`` — a fixed accelerator point, or a (PEs x NoC-bw) grid
    with area/power budgets (which turns the query into a co-DSE);
  * ``SearchSpec`` — objective / budget / strategy / fusion / co-DSE
    knobs, including the adaptive per-layer budget policy.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any, Sequence

from ..core import dnn_models as zoo
from ..core import tensor_analysis as ta
from ..core.dse import DSEConfig
from ..core.performance import HWConfig
from ..core.tensor_analysis import LayerOp
# One source of truth for the engine/schema version: bumping it
# invalidates disk-cached results (it is baked into every
# ``mapspace.cache.search_key`` AND every query fingerprint).
from ..mapspace.cache import ENGINE_SCHEMA_VERSION as SCHEMA_VERSION
from ..resilience.errors import SpecError

# Valid enum fields, restated as literals so constructing a Query never
# imports the torch-heavy engine modules (tests/test_torch_api.py holds
# them to mapspace.search's).
VALID_OBJECTIVES = ("edp", "energy", "runtime", "throughput")
VALID_STRATEGIES = ("auto", "exhaustive", "random", "greedy", "genetic")
VALID_PIPELINES = ("gene", "legacy")
VALID_BUDGET_POLICIES = ("adaptive", "uniform")


def _check_enum(value: str, valid: Sequence[str], field: str) -> None:
    if value not in valid:
        raise SpecError(f"{field} must be one of {sorted(valid)}, "
                        f"got {value!r}", field=field)


def _check_min(value, lo, field: str) -> None:
    if value is not None and not value >= lo:
        raise SpecError(f"{field} must be >= {lo}, got {value!r}",
                        field=field)


def _check_range(rng: Sequence | None, lo, field: str) -> None:
    if rng is None:
        return
    if len(rng) == 0:
        raise SpecError(f"{field} must be non-empty", field=field)
    bad = [v for v in rng if not v >= lo]
    if bad:
        raise SpecError(f"{field} entries must be >= {lo}, got {bad}",
                        field=field)

# LayerOp constructors reachable from query JSON ({"type": ..., ...}).
OP_BUILDERS = {
    "conv2d": ta.conv2d,
    "dwconv2d": ta.dwconv2d,
    "pool2d": ta.pool2d,
    "fc": ta.fc,
    "gemm": ta.gemm,
    "pointwise_conv": ta.pointwise_conv,
    "conv1d": ta.conv1d,
    "lstm_cell": ta.lstm_cell,
    "attention_score": ta.attention_score,
}


def op_from_json(d: dict[str, Any]) -> LayerOp:
    """Build a :class:`LayerOp` from a query-JSON op dict:
    ``{"type": "conv2d", "name": ..., "k": ..., ...}``."""
    d = dict(d)
    kind = d.pop("type", None)
    if kind not in OP_BUILDERS:
        raise SpecError(f"unknown op type {kind!r}; "
                        f"one of {sorted(OP_BUILDERS)}", field="type")
    d.setdefault("name", kind)
    name = d.pop("name")
    try:
        return OP_BUILDERS[kind](name, **d)
    except TypeError as e:
        raise SpecError(f"bad {kind!r} op fields: {e}", field=kind) from e


def _op_descriptor(op: LayerOp) -> dict[str, Any]:
    """Identifying (not necessarily reconstructing) JSON for a LayerOp."""
    return {"name": op.name, "op_type": op.op_type, "dims": dict(op.dims)}


def select_layers(layers: Sequence[LayerOp], which: str
                  ) -> list[LayerOp]:
    """Resolve a layer selector: an index, a name substring, ``all``, or
    a comma-separated list of those — model order, deduplicated.  (The
    historical ``mapsearch --layer`` semantics, now shared by every
    front end.)"""
    layers = list(layers)
    if which == "all":
        return layers
    out: list[LayerOp] = []
    for part in str(which).split(","):
        part = part.strip()
        if not part:
            continue
        if part.lstrip("-").isdigit():
            out.append(layers[int(part)])
            continue
        matches = [l for l in layers if part in l.name]
        if not matches:
            raise ValueError(f"no layer matching {part!r}")
        out.extend(matches)
    seen: set[str] = set()
    uniq = [l for l in out if not (l.name in seen or seen.add(l.name))]
    if not uniq:
        raise ValueError(f"no layer matching {which!r}")
    order = [l.name for l in layers]
    return sorted(uniq, key=lambda l: order.index(l.name))


@dataclasses.dataclass(frozen=True)
class Workload:
    """What to search a schedule/mapping for.

    Three shapes, normalized by :meth:`resolve`:

      * ``Workload.layer(op)`` / ``Workload(model=..., layer=...)`` —
        ONE layer (a mapping search);
      * ``Workload.layers([...])`` — an explicit layer list (a network
        schedule search);
      * ``Workload.network("vgg16")`` — a named zoo network.
    """
    model: str | None = None          # zoo model name
    layer: str | None = None          # selector within model (layer query)
    ops: tuple[LayerOp, ...] = ()     # explicit layers

    @staticmethod
    def of_layer(op: LayerOp) -> "Workload":
        return Workload(ops=(op,))

    @staticmethod
    def of_layers(ops: Sequence[LayerOp]) -> "Workload":
        return Workload(ops=tuple(ops))

    @staticmethod
    def of_network(model: str) -> "Workload":
        return Workload(model=model)

    def __post_init__(self) -> None:
        if self.ops and self.model:
            raise SpecError("Workload: give ops OR model, not both",
                            field="model")
        if not self.ops and not self.model:
            raise SpecError("Workload: needs ops or a model name",
                            field="ops")
        if self.layer is not None and not self.model:
            raise SpecError("Workload: layer selector needs a model",
                            field="layer")
        if self.model is not None and self.model not in zoo.MODELS:
            raise SpecError(f"unknown model {self.model!r}; "
                            f"one of {sorted(zoo.MODELS)}", field="model")

    def resolve(self) -> list[LayerOp]:
        if self.ops:
            return list(self.ops)
        layers = zoo.MODELS[self.model]()
        if self.layer is None:
            return layers
        return select_layers(layers, self.layer)

    @property
    def kind(self) -> str:
        """``"layer"`` (single-layer mapping query) or ``"network"``."""
        if self.ops:
            return "layer" if len(self.ops) == 1 else "network"
        if self.layer is None:
            return "network"
        return "layer" if len(self.resolve()) == 1 else "network"

    def describe(self) -> dict[str, Any]:
        if self.model:
            d: dict[str, Any] = {"model": self.model}
            if self.layer is not None:
                d["layer"] = self.layer
            return d
        if len(self.ops) == 1:
            return {"op": _op_descriptor(self.ops[0])}
        return {"layers": [_op_descriptor(o) for o in self.ops]}

    @staticmethod
    def from_json(d: dict[str, Any]) -> "Workload":
        if "op" in d:
            return Workload.of_layer(op_from_json(d["op"]))
        if "layers" in d:
            return Workload.of_layers([op_from_json(o)
                                       for o in d["layers"]])
        if "model" in d:
            layer = d.get("layer")
            return Workload(model=d["model"],
                            layer=None if layer is None else str(layer))
        raise ValueError(f"workload needs 'op', 'layers' or 'model': {d}")


@dataclasses.dataclass(frozen=True)
class Hardware:
    """A fixed accelerator point — or, when ``pe_range``/``bw_range`` are
    set, a hardware grid (the query becomes a joint mapping x hardware
    co-DSE under the area/power budgets)."""
    num_pes: int = 256
    noc_bw: float = 32.0
    noc_latency: float = 2.0
    # network-schedule cost-model fields (repro_torch.netspace)
    dram_bw: float = 16.0
    dram_energy_pj: float = 100.0
    reconfig_latency: float = 0.0
    # grid axes -> co-DSE
    pe_range: tuple[int, ...] | None = None
    bw_range: tuple[float, ...] | None = None
    area_budget_mm2: float | None = None
    power_budget_mw: float | None = None

    def __post_init__(self) -> None:
        _check_min(self.num_pes, 1, "num_pes")
        for f in ("noc_bw", "dram_bw"):
            if not getattr(self, f) > 0:
                raise SpecError(f"{f} must be > 0, "
                                f"got {getattr(self, f)!r}", field=f)
        for f in ("noc_latency", "dram_energy_pj", "reconfig_latency"):
            _check_min(getattr(self, f), 0, f)
        _check_range(self.pe_range, 1, "pe_range")
        _check_range(self.bw_range, 1e-9, "bw_range")
        _check_min(self.area_budget_mm2, 1e-9, "area_budget_mm2")
        _check_min(self.power_budget_mw, 1e-9, "power_budget_mw")

    @property
    def is_grid(self) -> bool:
        return self.pe_range is not None or self.bw_range is not None

    def hwconfig(self) -> HWConfig:
        return HWConfig(num_pes=self.num_pes, noc_bw=self.noc_bw,
                        noc_latency=self.noc_latency,
                        dram_bw=self.dram_bw,
                        dram_energy_pj=self.dram_energy_pj,
                        reconfig_latency=self.reconfig_latency)

    def dse_config(self) -> DSEConfig:
        base = DSEConfig()
        kw: dict[str, Any] = {}
        if self.pe_range is not None:
            kw["pe_range"] = tuple(int(p) for p in self.pe_range)
        if self.bw_range is not None:
            kw["bw_range"] = tuple(float(b) for b in self.bw_range)
        if self.area_budget_mm2 is not None:
            kw["area_budget_mm2"] = float(self.area_budget_mm2)
        if self.power_budget_mw is not None:
            kw["power_budget_mw"] = float(self.power_budget_mw)
        return dataclasses.replace(base, **kw)

    def describe(self) -> dict[str, Any]:
        d = dataclasses.asdict(self)
        return {k: v for k, v in d.items() if v is not None}

    @staticmethod
    def from_json(d: dict[str, Any]) -> "Hardware":
        d = dict(d)
        for k in ("pe_range", "bw_range"):
            if d.get(k) is not None:
                d[k] = tuple(d[k])
        known = {f.name for f in dataclasses.fields(Hardware)}
        bad = set(d) - known
        if bad:
            raise SpecError(f"unknown Hardware fields: {sorted(bad)}",
                            field=sorted(bad)[0])
        return Hardware(**d)


@dataclasses.dataclass(frozen=True)
class SearchSpec:
    """How to search: objective, budget, strategy and the engine knobs.

    ``budget_policy`` applies to network queries: ``"adaptive"`` (the
    new-API default) spends a cheap uniform first pass, then refines the
    layers that dominate network cost; ``"uniform"`` is the legacy
    equal-budget behaviour.  ``joint_genes``/``codse_top_k`` only matter
    for grid-hardware (co-DSE) queries."""
    objective: str = "edp"
    budget: int = 512
    strategy: str = "auto"
    seed: int = 0
    top_k: int = 8
    # network-schedule knobs
    frontier_k: int = 8
    fuse: bool = True
    reconfig: bool = True
    composer: str = "auto"
    l2_budget_kb: float | None = None
    budget_policy: str = "adaptive"     # adaptive | uniform
    # space/pruning knobs
    cluster: bool = True
    dims: tuple[str, ...] | None = None  # explicit searched dims (layer
    #                                      queries; None = auto)
    l1_prune_kb: float | None = None
    l2_prune_kb: float | None = None
    # engine knobs
    population: int | None = None
    block: int = 1024
    pipeline: str = "gene"              # gene | legacy (layer queries;
    #                                     legacy = tuple-point oracle)
    multicast: bool = True
    spatial_reduction: bool = True
    # co-DSE knobs
    codse_top_k: int = 4
    joint_genes: int = 0
    # serving knobs: wall-clock budget for the whole query.  Enforced
    # cooperatively at chunk boundaries (a device pass cannot be
    # preempted); an expired query raises BudgetExceeded, never hangs.
    # None (the default) keeps offline queries unbounded and —
    # because describe() drops None fields — existing fingerprints
    # unchanged.
    deadline_s: float | None = None

    def __post_init__(self) -> None:
        _check_enum(self.objective, VALID_OBJECTIVES, "objective")
        _check_enum(self.strategy, VALID_STRATEGIES, "strategy")
        _check_enum(self.pipeline, VALID_PIPELINES, "pipeline")
        _check_enum(self.budget_policy, VALID_BUDGET_POLICIES,
                    "budget_policy")
        for f in ("budget", "top_k", "frontier_k", "block",
                  "codse_top_k"):
            _check_min(getattr(self, f), 1, f)
        _check_min(self.population, 1, "population")
        _check_min(self.joint_genes, 0, "joint_genes")
        _check_min(self.l1_prune_kb, 1e-9, "l1_prune_kb")
        _check_min(self.l2_prune_kb, 1e-9, "l2_prune_kb")
        _check_min(self.l2_budget_kb, 1e-9, "l2_budget_kb")
        _check_min(self.deadline_s, 1e-9, "deadline_s")

    def describe(self) -> dict[str, Any]:
        return {k: v for k, v in dataclasses.asdict(self).items()
                if v is not None}

    @staticmethod
    def from_json(d: dict[str, Any]) -> "SearchSpec":
        d = dict(d)
        if d.get("dims") is not None:
            d["dims"] = tuple(d["dims"])
        known = {f.name for f in dataclasses.fields(SearchSpec)}
        bad = set(d) - known
        if bad:
            raise SpecError(f"unknown SearchSpec fields: {sorted(bad)}",
                            field=sorted(bad)[0])
        return SearchSpec(**d)


@dataclasses.dataclass(frozen=True)
class Query:
    """One declarative request: workload x hardware x search spec."""
    workload: Workload
    hardware: Hardware = Hardware()
    search: SearchSpec = SearchSpec()
    tag: str | None = None            # caller-visible label (batch files)

    @property
    def kind(self) -> str:
        """Engine route: ``layer`` / ``layer_codse`` / ``network`` /
        ``network_codse``."""
        base = self.workload.kind
        return f"{base}_codse" if self.hardware.is_grid else base

    def describe(self) -> dict[str, Any]:
        d: dict[str, Any] = {
            "workload": self.workload.describe(),
            "hardware": self.hardware.describe(),
            "search": self.search.describe(),
        }
        if self.tag is not None:
            d["tag"] = self.tag
        return d

    def estimated_cost(self) -> float:
        """Admission-control cost estimate: roughly the number of
        candidate evaluations the query can trigger.  A fixed hardware
        point scores ``budget x n_layers``; a co-DSE grid multiplies by
        the hardware-grid size (plus the joint-gene sweep) — exactly the
        "grid bomb" shape overload shedding needs to price *before* any
        engine work runs.  Never raises: an unresolvable workload prices
        as a single layer."""
        try:
            n_layers = len(self.workload.resolve())
        except Exception:  # noqa: BLE001 — sizing only, run() will raise
            n_layers = 1
        n_hw = 1
        if self.hardware.is_grid:
            cfg = self.hardware.dse_config()
            n_hw = len(cfg.pe_range) * len(cfg.bw_range)
        cost = float(self.search.budget) * n_layers * n_hw
        if self.hardware.is_grid and self.search.joint_genes:
            cost += float(self.search.joint_genes) * n_hw
        return cost

    def lint(self) -> None:
        """Static legality lint (``repro_torch.analysis.speclint``):
        searched dims, space constructibility, and the analytic
        buffer-budget feasibility bound — raises a one-line
        :class:`SpecError` with the structured findings attached when the
        query cannot possibly produce a result, all before any device
        work.  The serving tier calls this pre-admission so an illegal
        query is a 400, not a burned flush slot."""
        from ..analysis.speclint import check_query
        check_query(self)

    def fingerprint(self) -> str:
        """Stable content hash of the FULL query plus the engine/schema
        version — the disk-cache key component that keeps stale
        prior-schema results from being replayed."""
        txt = json.dumps({"schema": SCHEMA_VERSION, **self.describe()},
                         sort_keys=True, default=str)
        return hashlib.sha256(txt.encode()).hexdigest()[:24]

    @staticmethod
    def from_json(d: dict[str, Any]) -> "Query":
        if "workload" in d:
            wl = Workload.from_json(d["workload"])
        else:                          # flat form: workload keys top-level
            wl = Workload.from_json(d)
        return Query(
            workload=wl,
            hardware=Hardware.from_json(d.get("hardware", {})),
            search=SearchSpec.from_json(d.get("search", {})),
            tag=d.get("tag"))


def queries_from_file(path: str) -> list[Query]:
    """Load a ``queries.json`` batch: a JSON list of query dicts (or
    ``{"queries": [...]}``)."""
    with open(path) as f:
        payload = json.load(f)
    if isinstance(payload, dict):
        payload = payload.get("queries", [])
    return [Query.from_json(d) for d in payload]
