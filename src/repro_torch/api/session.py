"""The long-lived query engine behind the declarative front door — the
port of ``repro.api.session``.

A :class:`Session` owns what should outlive one query:

  * the on-disk RESULT cache (``cache_dir`` — ``mapspace.cache``, keyed
    by the full query fingerprint + engine schema version);
  * the device its queries run on (``cuda`` unless the caller names
    another; without a GPU a query raises instead of running elsewhere);
  * the resilience knobs (checkpoints, retry policy, degrade, faults);
  * the built network spaces of coalesced batches, keyed by their
    distinct layer shapes, so a repeated batch reuses its family spaces
    and the warm (op-class, level-count) evaluators behind them.

The reference's session also owns a persistent XLA compilation cache
(``jax_cache_dir``).  The port compiles nothing — its evaluators are
eager PyTorch and hand-written kernels built once per process — so that
argument is gone, and ``n_compiles`` counts each evaluator's first pass
at a (spec, block) shape instead.

``Session.run(query)`` routes one query to its engine (``layer``,
``layer_codse``, ``network``, ``network_codse``).  ``Session.run_many
(queries)`` / ``submit()``+``flush()`` answer a batch: heterogeneous
single-layer queries that share an (op-class, level-count) family are
COALESCED into one padded gene-tensor device pass through the
shape-as-operand evaluators (``netspace``'s ``ext_operand`` machinery),
answered on the host from the shipped (runtime, energy, L1, L2) columns.
Hardware points ride as per-row operands, so queries at different fixed
designs still share one evaluator.
"""
from __future__ import annotations

import dataclasses
import hashlib
import logging
import os
import time
from typing import Any, Sequence

import numpy as np
import torch

from .. import obs
from ..core import dnn_models as zoo
from ..core.tensor_analysis import LayerOp
from ..devices import resolve_device
from ..resilience import (BudgetExceeded, DeviceError, ReproError,
                          ResilienceConfig, SpecError, SweepCheckpoint,
                          SweepKilled, cancel_scope, classify)
from .report import Report
from .spec import Query

LOG = logging.getLogger("repro_torch.resilience")

# Objective value from the composer columns (canonical minimize);
# throughput needs the layer's MAC count.
_COL_RUNTIME, _COL_ENERGY = 0, 1


def _objective_from_cols(cols: np.ndarray, objective: str,
                         macs: float) -> np.ndarray:
    r = cols[:, _COL_RUNTIME]
    e = cols[:, _COL_ENERGY]
    if objective == "edp":
        return e * r
    if objective == "energy":
        return e
    if objective == "runtime":
        return r
    if objective == "throughput":
        return -(macs / np.maximum(r, 1e-12))
    raise ValueError(f"unknown objective {objective!r}")


def _stats_from_col(col: np.ndarray, macs: float) -> dict[str, float]:
    r, e = float(col[0]), float(col[1])
    return {"runtime": r, "energy_pj": e, "l1_kb": float(col[2]),
            "l2_kb": float(col[3]), "edp": e * r,
            "throughput": macs / max(r, 1e-12)}


def _deadline_t(query: Query) -> float | None:
    """The query's ``deadline_s`` budget as an absolute monotonic
    deadline for :func:`~repro_torch.resilience.cancel_scope` (None = no
    budget)."""
    dl = query.search.deadline_s
    return None if dl is None else time.monotonic() + dl


def _batch_deadline_t(queries: Sequence[Query]) -> float | None:
    """A coalesced flush shares ONE device pass, so its cancel scope is
    bounded by the most patient member: the max of the members' budgets
    (members with no budget don't cap the flush — their work continues
    past their neighbours' deadlines)."""
    dls = [q.search.deadline_s for q in queries]
    if any(d is None for d in dls) or not dls:
        return None
    return time.monotonic() + max(dls)


class FamilyBest:
    """Decodable handle a coalesced report carries in ``Report.raw``:
    the winning gene row lives in the SHARED family space (padded tile
    axes, class-level cluster plan), which differs from the space
    ``build_space(op)`` would give the same layer — so the report ships
    the space alongside the point."""

    def __init__(self, op: LayerOp, space, point: tuple):
        self.op = op
        self.space = space
        self.point = point

    @property
    def best_dataflow(self):
        from ..mapspace.space import point_dataflow
        return point_dataflow(self.space, self.point)


class PendingReport:
    """Handle returned by :meth:`Session.submit`; resolves when the
    session flushes (explicitly or on first ``result()`` call)."""

    def __init__(self, session: "Session", query: Query):
        self._session = session
        self.query = query
        self._report: Report | None = None

    def done(self) -> bool:
        return self._report is not None

    def result(self) -> Report:
        if self._report is None:
            self._session.flush()
        assert self._report is not None
        return self._report


class Session:
    """See module docstring.  ``devices`` defaults every query's CUDA
    device count (None = all); ``device`` is where queries run (None =
    ``cuda``); ``cache_dir=None`` disables the result cache."""

    def __init__(self, *, cache_dir: str | None = None,
                 devices: int | None = None,
                 resilience: ResilienceConfig | None = None,
                 device: str | torch.device | None = None):
        expand = lambda p: os.path.expanduser(p) if p else p  # noqa: E731
        self.cache_dir = expand(cache_dir)
        self.devices = devices
        self.device = device
        self.resilience = resilience or ResilienceConfig()
        if resilience is not None:
            # explicit config: install its fault spec + retry policy
            # process-wide (the chunk loops read the installed policy)
            self.resilience.install()
        if self.resilience.ckpt_dir:
            self.resilience = dataclasses.replace(
                self.resilience, ckpt_dir=expand(self.resilience.ckpt_dir))
        self.n_queries = 0
        self.last_batch: dict[str, Any] | None = None
        self._queue: list[tuple[Query, PendingReport]] = []
        self._netspaces: dict[tuple, Any] = {}

    # ------------------------------------------------------------------
    # Single-query routing
    # ------------------------------------------------------------------

    def run(self, query: Query) -> Report:
        """Route one query to its engine and answer in the unified
        :class:`Report` schema.

        This is the error boundary of the front door: any engine
        failure surfaces as a one-line :class:`~.resilience.ReproError`
        (``SpecError`` / ``DeviceError`` / ``CacheError``) instead of a
        deep traceback, and — with ``resilience.degrade`` (the default) —
        a layer query whose gene pipeline keeps failing is re-answered by
        the legacy tuple-point pipeline on the same device, with a
        ``degraded`` extras block, rather than failing.  The device is
        resolved before the boundary: a missing GPU raises, it is never
        degraded around."""
        kind = query.kind
        resolve_device(self.device)
        self.n_queries += 1
        met = obs.metrics()
        met.inc("session.queries")
        met.inc("session.queries_by_kind", kind=kind)
        # query fingerprint = the span's trace id (only computed when a
        # tracer is live; span() itself is a no-op singleton otherwise)
        fp = query.fingerprint() if obs.tracing_enabled() else None
        acc = obs.PhaseBreakdown()
        t_q = time.perf_counter()
        with obs.span("query", kind=kind, id=fp), \
                cancel_scope(_deadline_t(query)):
            try:
                with obs.phase_scope(acc):
                    rep = self._route(kind, query)
            except SweepKilled:
                raise              # injected process death: must escape
            except Exception as e:  # noqa: BLE001 — classified here
                err = classify(e, context=f"{kind} query")
                if (self.resilience.degrade and kind == "layer"
                        and query.search.pipeline == "gene"
                        and isinstance(err, DeviceError)):
                    rep = self._degrade_layer(query, err)
                    self._stamp_timing(rep, t_q, acc)
                    return rep
                if err is e:
                    raise
                raise err from e
            self._stamp_timing(rep, t_q, acc)
            return rep

    def _route(self, kind: str, query: Query) -> Report:
        if kind == "layer":
            return self._run_layer(query)
        if kind == "layer_codse":
            return self._run_layer_codse(query)
        if kind == "network":
            return self._run_network(query)
        if kind == "network_codse":
            return self._run_network_codse(query)
        raise SpecError(f"unroutable query kind {kind!r}",
                        field="workload")

    def _degrade_layer(self, query: Query, err: ReproError) -> Report:
        """Persistent gene-pipeline failure: answer through the legacy
        tuple-point pipeline on the same device instead of failing the
        query; the report says so in ``extras['degraded']``."""
        obs.metrics().inc("resilience.degraded_queries")
        obs.instant("degraded", kind="layer", error=type(err).__name__)
        LOG.warning("gene pipeline failed (%s) — degrading query to the "
                    "legacy pipeline", err.one_line())
        legacy = dataclasses.replace(
            query,
            search=dataclasses.replace(query.search, pipeline="legacy"))
        rep = self._run_layer(legacy)
        rep.extras["degraded"] = {"from": "gene", "to": "legacy",
                                  "error": err.one_line()}
        return rep

    @staticmethod
    def _stamp_timing(rep: Report, t0_pc: float,
                      acc: "obs.PhaseBreakdown") -> None:
        """Attach the measured phase breakdown to a report: engine span
        durations accumulated in ``acc`` plus an ``other`` residual, so
        the phases sum to the measured wall by construction.  First
        stamp wins: an isolated re-run's inner stamp survives the
        family-level one."""
        if "timing" not in rep.extras:
            rep.extras["timing"] = obs.timing_breakdown(
                time.perf_counter() - t0_pc, acc.snapshot())

    def _result_cache_stats(self) -> dict[str, Any]:
        """On-disk result-cache occupancy + this process's hit ratio.
        Occupancy is measured from the directory (shared across
        processes) by ``mapspace.cache.cache_stats``, which also
        publishes the ``result_cache.entries``/``.bytes`` gauges;
        hits/misses are this process's counters."""
        from ..mapspace import cache as result_cache
        entries, size = result_cache.cache_stats(self.cache_dir)
        snap = obs.metrics().snapshot()["counters"]
        hits = int(snap.get("result_cache.hits", 0))
        misses = int(snap.get("result_cache.misses", 0))
        return {"entries": entries, "bytes": size,
                "hits": hits, "misses": misses,
                "hit_ratio": round(hits / (hits + misses), 4)
                if hits + misses else None}

    def metrics(self) -> dict[str, Any]:
        """The process-wide obs metrics snapshot plus this session's own
        counters (the structured payload the CLIs' ``--metrics`` print)."""
        cache = self._result_cache_stats()   # sets gauges pre-snapshot
        snap = obs.metrics().snapshot()
        snap["session"] = {"n_queries": self.n_queries,
                           "last_batch": self.last_batch,
                           "result_cache": cache}
        return snap

    def run_search(self, op: LayerOp, **kwargs) -> Any:
        """The session path behind ``mapspace.search()``: forwards to the
        engine (bit-equal by construction) on the session's device unless
        the call names one, while the session keeps the query count."""
        from ..mapspace.search import search_impl
        self.n_queries += 1
        kwargs.setdefault("device", self.device)
        return search_impl(op, **kwargs)

    def run_co_search(self, op: LayerOp, **kwargs) -> Any:
        """Session path behind ``mapspace.co_search()``."""
        from ..mapspace.codse import co_search_impl
        self.n_queries += 1
        kwargs.setdefault("device", self.device)
        return co_search_impl(op, **kwargs)

    def run_search_network(self, model, **kwargs) -> Any:
        """Session path behind ``netspace.search_network()``."""
        from ..netspace.search import search_network_impl
        self.n_queries += 1
        kwargs.setdefault("device", self.device)
        return search_network_impl(model, **kwargs)

    def run_co_search_network(self, model, **kwargs) -> Any:
        """Session path behind ``netspace.co_search_network()``."""
        from ..netspace.search import co_search_network_impl
        self.n_queries += 1
        kwargs.setdefault("device", self.device)
        return co_search_network_impl(model, **kwargs)

    def _layer_search_kwargs(self, query: Query) -> dict[str, Any]:
        sp = query.search
        hw = query.hardware
        return dict(
            objective=sp.objective, budget=sp.budget,
            num_pes=hw.num_pes, noc_bw=hw.noc_bw,
            strategy=sp.strategy, seed=sp.seed, top_k=sp.top_k,
            population=sp.population, block=sp.block,
            pipeline=sp.pipeline, multicast=sp.multicast,
            spatial_reduction=sp.spatial_reduction,
            l1_budget_kb=sp.l1_prune_kb, l2_budget_kb=sp.l2_prune_kb,
            devices=self.devices, ckpt_dir=self.resilience.ckpt_dir)

    def _layer_space(self, query: Query, op: LayerOp):
        sp = query.search
        if sp.cluster and sp.dims is None:
            return None                # engine builds the default space
        from ..mapspace.space import build_space
        return build_space(op, dims=sp.dims, cluster=sp.cluster)

    def _run_layer(self, query: Query) -> Report:
        from ..mapspace.search import search_impl
        (op,) = query.workload.resolve()
        r = search_impl(op, space=self._layer_space(query, op),
                        cache_dir=self.cache_dir,
                        cache_extra=query.fingerprint(),
                        device=self.device,
                        **self._layer_search_kwargs(query))
        rep = Report.from_search(r, query)
        rep.name = op.name
        return rep

    def _run_layer_codse(self, query: Query) -> Report:
        from ..mapspace.codse import co_search_impl
        sp = query.search
        hw = query.hardware
        (op,) = query.workload.resolve()
        kw = self._layer_search_kwargs(query)
        for k in ("objective", "budget", "num_pes", "noc_bw", "seed",
                  "ckpt_dir"):
            kw.pop(k)
        co = co_search_impl(
            op, objective=sp.objective, mapping_budget=sp.budget,
            top_k=sp.codse_top_k, cfg=hw.dse_config(),
            num_pes=hw.num_pes, noc_bw=hw.noc_bw, seed=sp.seed,
            space=self._layer_space(query, op),
            cache_dir=self.cache_dir, joint_genes=sp.joint_genes,
            ckpt_dir=self.resilience.ckpt_dir,
            cache_extra=query.fingerprint(), search_kwargs=kw,
            device=self.device)
        rep = Report.from_codse(co, query)
        rep.name = op.name
        return rep

    def _network_kwargs(self, query: Query) -> dict[str, Any]:
        sp = query.search
        hw = query.hardware
        if sp.strategy not in ("auto", "exhaustive", "random"):
            raise SpecError(
                f"network queries need a one-pass strategy "
                f"(auto/exhaustive/random), got {sp.strategy!r}",
                field="strategy")
        return dict(
            objective=sp.objective, budget=sp.budget, seed=sp.seed,
            strategy=sp.strategy, frontier_k=sp.frontier_k,
            fuse=sp.fuse, reconfig=sp.reconfig,
            l2_budget_kb=sp.l2_budget_kb, l1_prune_kb=sp.l1_prune_kb,
            l2_prune_kb=sp.l2_prune_kb, hw=hw.hwconfig(),
            composer=sp.composer, devices=self.devices, block=sp.block,
            multicast=sp.multicast,
            spatial_reduction=sp.spatial_reduction,
            budget_policy=sp.budget_policy,
            build_kwargs={"cluster": sp.cluster}, device=self.device)

    def _net_name(self, query: Query, layers: Sequence[LayerOp]) -> str:
        return query.workload.model or f"{len(layers)} layers"

    def _run_network(self, query: Query) -> Report:
        from ..netspace.search import search_network_impl
        layers = query.workload.resolve()
        r = search_network_impl(layers, **self._network_kwargs(query))
        rep = Report.from_network(r, query)
        rep.name = self._net_name(query, layers)
        return rep

    def _run_network_codse(self, query: Query) -> Report:
        from ..netspace.search import co_search_network_impl
        sp = query.search
        hw = query.hardware
        layers = query.workload.resolve()
        kw = self._network_kwargs(query)
        for k in ("objective", "budget", "seed", "frontier_k"):
            kw.pop(k)
        co = co_search_network_impl(
            layers, hw.dse_config(), objective=sp.objective,
            budget=sp.budget, num_pes=hw.num_pes, noc_bw=hw.noc_bw,
            seed=sp.seed, frontier_k=sp.frontier_k,
            refine_k=sp.codse_top_k, **kw)
        rep = Report.from_conet(co, query)
        rep.name = self._net_name(query, layers)
        return rep

    # ------------------------------------------------------------------
    # Cross-query batching
    # ------------------------------------------------------------------

    @staticmethod
    def coalescible(query: Query) -> bool:
        """Whether ``run_many`` can fold this query into a shared family
        pass: a single-layer workload at fixed hardware with a one-pass
        candidate strategy.  Everything else falls back to
        :meth:`run`."""
        return (query.kind == "layer"
                and query.search.dims is None
                and query.search.pipeline == "gene"
                and query.search.strategy in ("auto", "exhaustive",
                                              "random"))

    def _netspace_for(self, ops: Sequence[LayerOp], *, cluster: bool):
        """Build (or reuse) the shared-gene-layout family grouping over a
        set of distinct layers — the session's warm-evaluator registry
        rides on these spaces' op-class specs."""
        from ..netspace.space import build_netspace
        key = (tuple(zoo.layer_shape_key(op) for op in ops), cluster)
        ns = self._netspaces.get(key)
        if ns is None:
            ns = build_netspace(list(ops), cluster=cluster)
            self._netspaces[key] = ns
        return ns

    def _batch_settings(self, query: Query) -> tuple:
        sp = query.search
        return (sp.block, sp.multicast, sp.spatial_reduction, sp.cluster)

    def run_many(self, queries: Sequence[Query], *,
                 coalesce: bool = True) -> list[Report]:
        """Answer a heterogeneous batch.  Coalescible layer queries are
        grouped by engine settings, their layers folded into shared
        family spaces, and ALL their candidates evaluated through one
        shape-as-operand device pass per (op-class, level-count) family —
        at most one warm-up pass each, with per-row hardware operands —
        on the session's device (a missing GPU raises before any query
        runs, never degraded around).
        ``coalesce=False`` evaluates each query separately through the
        SAME family spaces (the determinism oracle: results must be
        bit-equal to the coalesced pass).  Non-coalescible queries
        (networks, hardware grids, adaptive strategies, custom dims,
        the legacy pipeline) run via :meth:`run` in order.

        Note the family-space semantics: a coalesced answer searches the
        layer's CLASS space (padded tile axes, class-level cluster plan,
        ``auto`` resolving to exhaustive/random) — like
        ``netspace.search_network`` and unlike single-query
        :meth:`run`, which searches ``build_space(op)`` and escalates
        oversized ``auto`` spaces to greedy refinement.  ``Report.raw``
        carries the family space so winning genes stay decodable
        (``raw.best_dataflow``)."""
        resolve_device(self.device)
        t0 = time.perf_counter()
        queries = list(queries)
        obs.metrics().inc("session.batches")
        reports: list[Report | None] = [None] * len(queries)
        coal: dict[tuple, list[int]] = {}
        budget_rest = 0
        n_compiles = 0
        with obs.span("run_many", queries=len(queries)):
            for i, q in enumerate(queries):
                if self.coalescible(q):
                    coal.setdefault(self._batch_settings(q), []).append(i)
                else:
                    t_q = time.monotonic()
                    try:
                        reports[i] = self.run(q)
                    except BudgetExceeded:
                        # deadline expiry is a per-request terminal
                        # answer, never a batch poison
                        obs.metrics().inc("session.timeouts")
                        rep = Report.timeout(
                            q, deadline_s=q.search.deadline_s,
                            waited_s=time.monotonic() - t_q,
                            where="run")
                        rep.extras["timing"] = obs.timing_breakdown(
                            time.monotonic() - t_q, {})
                        reports[i] = rep
                        continue
                    budget_rest += self._compile_budget_of(reports[i])
                    n_compiles += reports[i].n_compiles
            n_coal = sum(len(v) for v in coal.values())
            n_families = 0
            compile_s = eval_s = encode_s = 0.0
            n_devices = 1
            for settings, idxs in coal.items():
                members = [queries[i] for i in idxs]
                t_fam = time.monotonic()
                # family-level phase breakdown: the device pass is
                # shared, so every member carries the SAME wall/phases
                # (the serving tier re-finalizes with queue_wait)
                acc = obs.PhaseBreakdown()
                t_fam_pc = time.perf_counter()
                try:
                    with cancel_scope(_batch_deadline_t(members)), \
                            obs.phase_scope(acc):
                        out = self._run_family_batch(members, settings,
                                                     coalesce=coalesce)
                except SweepKilled:
                    raise          # injected process death: must escape
                except BudgetExceeded:
                    # the flush outlived its most patient member's
                    # budget: every unanswered member gets a terminal
                    # timeout report (re-running them per-query would
                    # only burn MORE wall past the deadline)
                    out = self._timeout_batch(
                        members, waited_s=time.monotonic() - t_fam)
                except Exception as e:  # noqa: BLE001 — isolated below
                    if not self.resilience.degrade:
                        raise classify(e, context="coalesced batch") \
                            from e
                    out = self._isolate_batch(members, e)
                for i, rep in zip(idxs, out["reports"]):
                    self._stamp_timing(rep, t_fam_pc, acc)
                    reports[i] = rep
                n_compiles += out["n_compiles"]
                n_families += out["n_families"]
                compile_s += out["compile_s"]
                eval_s += out["eval_s"]
                encode_s += out["encode_s"]
                n_devices = max(n_devices, out["n_devices"])
        self.last_batch = {
            "n_queries": len(queries),
            "n_coalesced": n_coal,
            "coalesce": bool(coalesce),
            "n_families": n_families,
            "n_compiles": n_compiles,
            "compile_budget": n_families + budget_rest,
            "compile_s": round(compile_s, 3),
            "eval_s": round(eval_s, 3),
            "encode_s": round(encode_s, 3),
            "n_devices": n_devices,
            "elapsed_s": round(time.perf_counter() - t0, 3),
        }
        assert all(r is not None for r in reports)
        return list(reports)

    @staticmethod
    def _compile_budget_of(rep: Report) -> int:
        """Closed-form warm-up budget of a non-coalesced query (the
        compile-budget assertion sums these with the family count): one
        per evaluator shape the reference would compile."""
        if rep.kind == "layer":
            return 2
        if rep.kind == "layer_codse":
            joint = 2 if "joint" in rep.extras else 0
            return 2 + 2 * max(len(rep.raw.dse), 1) + joint
        n_classes = int(rep.extras.get("n_classes", 1))
        if rep.kind == "network":
            return 2 * n_classes
        return 4 * n_classes           # network_codse: ref + grid pass

    def _timeout_batch(self, queries: list[Query], *,
                       waited_s: float) -> dict[str, Any]:
        """A coalesced flush hit its deadline: answer every member with
        a terminal timeout report (partial marker in extras)."""
        met = obs.metrics()
        met.inc("session.batch_timeouts")
        met.inc("session.timeouts", len(queries))
        obs.instant("batch-timeout", queries=len(queries),
                    waited_s=round(waited_s, 3))
        LOG.warning("coalesced flush exceeded its deadline after %.3fs "
                    "— answering %d member(s) with timeout reports",
                    waited_s, len(queries))
        reports = [Report.timeout(q, deadline_s=q.search.deadline_s,
                                  waited_s=waited_s, where="flush")
                   for q in queries]
        return {"reports": reports, "n_compiles": 0, "n_families": 0,
                "compile_s": 0.0, "eval_s": 0.0, "encode_s": 0.0,
                "n_devices": 1}

    def _isolate_batch(self, queries: list[Query],
                       exc: BaseException) -> dict[str, Any]:
        """A coalesced device pass failed: degrade the batch to
        per-query sequential execution so one poisoned query cannot take
        down its neighbours.  Queries that STILL fail answer as
        ``error``-kind reports (the rest get normal single-query
        answers — note those search ``build_space(op)``, not the shared
        family space)."""
        err = classify(exc, context="coalesced batch")
        obs.metrics().inc("resilience.batch_degraded")
        obs.instant("batch-degraded", queries=len(queries),
                    error=type(err).__name__)
        LOG.warning("coalesced batch failed (%s) — degrading to "
                    "per-query sequential execution", err.one_line())
        reports: list[Report] = []
        n_compiles = 0
        n_devices = 1
        for q in queries:
            t_q = time.monotonic()
            try:
                rep = self.run(q)
                n_compiles += rep.n_compiles
                n_devices = max(n_devices, rep.n_devices)
            except SweepKilled:
                raise
            except BudgetExceeded:
                obs.metrics().inc("session.timeouts")
                rep = Report.timeout(q, deadline_s=q.search.deadline_s,
                                     waited_s=time.monotonic() - t_q,
                                     where="isolate")
                reports.append(rep)
                continue
            except Exception as qe:  # noqa: BLE001 — isolated per query
                rep = Report.from_error(q, classify(qe, context="query"))
            reports.append(rep)
        return {"reports": reports, "n_compiles": n_compiles,
                "n_families": 0, "compile_s": 0.0, "eval_s": 0.0,
                "encode_s": 0.0, "n_devices": n_devices}

    def _batch_ckpt(self, queries: list[Query],
                    grp: list[int]) -> SweepCheckpoint | None:
        """Sweep checkpoint for one coalesced family job, keyed by the
        member queries' fingerprints (stable across a re-run of the same
        batch, so a killed flush resumes bit-identically)."""
        if not self.resilience.ckpt_dir:
            return None
        key = hashlib.sha256("|".join(
            queries[qi].fingerprint() for qi in grp).encode()
        ).hexdigest()[:16]
        # save after every chunk: the state is tiny (top-k + frontier
        # candidates), and a killed flush then loses at most one chunk
        return SweepCheckpoint(self.resilience.ckpt_dir, f"batch-{key}",
                               every_chunks=1)

    def _run_family_batch(self, queries: list[Query], settings: tuple,
                          *, coalesce: bool) -> dict[str, Any]:
        from ..mapspace.search import static_candidates
        from ..mapspace.space import prune_genes_by_budget, gene_tables
        from ..mapspace.universal import GeneRun
        from ..netspace.evaluator import evaluate_rows
        block, multicast, spatial_reduction, cluster = settings

        with obs.span("coalesce", queries=len(queries)):
            ops = [q.workload.resolve()[0] for q in queries]
            # fold into distinct shapes (first-appearance order keeps the
            # family registry stable across repeated batches)
            distinct: list[LayerOp] = []
            seen: dict[tuple, int] = {}
            uid_of: list[int] = []
            for op in ops:
                k = zoo.layer_shape_key(op)
                if k not in seen:
                    seen[k] = len(distinct)
                    distinct.append(op)
                uid_of.append(seen[k])
            ns = self._netspace_for(distinct, cluster=cluster)
            # build_netspace dedupes again; map distinct ids through it
            uid_of = [ns.index[u] for u in uid_of]

            # per-query candidate matrices (the SAME draws one-query
            # netspace-style search would make on the shared space)
            cand: list[np.ndarray] = []
            strat: list[str] = []
            for q, op, u in zip(queries, ops, uid_of):
                sp = q.search
                g, s = static_candidates(ns.spaces[u], sp.strategy,
                                         sp.budget, sp.seed)
                g = prune_genes_by_budget(ns.unique[u], ns.spaces[u], g,
                                          l1_kb=sp.l1_prune_kb,
                                          l2_kb=sp.l2_prune_kb)
                if not g.shape[0]:
                    raise RuntimeError(
                        f"{op.name}: budget pruning dropped every "
                        f"candidate")
                cand.append(g)
                strat.append(s)

        run = GeneRun()
        cols_q: list[np.ndarray | None] = [None] * len(queries)
        n_families = 0
        by_class: dict[int, list[int]] = {}
        for qi, u in enumerate(uid_of):
            by_class.setdefault(ns.class_of[u], []).append(qi)
        for cid, members in by_class.items():
            tb = gene_tables(ns.unique[uid_of[members[0]]],
                             ns.spaces[uid_of[members[0]]])
            all_genes = np.concatenate([cand[qi] for qi in members])
            is2 = ~tb.cluster_is_none[all_genes[:, 2]]
            n_families += int((~is2).any()) + int(is2.any())
            jobs = [members] if coalesce else [[qi] for qi in members]
            for grp in jobs:
                uid = np.concatenate(
                    [np.full(cand[qi].shape[0], uid_of[qi], np.int64)
                     for qi in grp])
                genes = np.concatenate([cand[qi] for qi in grp])
                pes = np.concatenate(
                    [np.full(cand[qi].shape[0],
                             queries[qi].hardware.num_pes, np.float32)
                     for qi in grp])
                bw = np.concatenate(
                    [np.full(cand[qi].shape[0],
                             queries[qi].hardware.noc_bw, np.float32)
                     for qi in grp])
                _, cols = evaluate_rows(
                    ns, uid, genes, objective="edp", num_pes=pes,
                    noc_bw=bw, block=block, n_devices=self.devices,
                    multicast=multicast,
                    spatial_reduction=spatial_reduction, run=run,
                    ckpt=self._batch_ckpt(queries, grp),
                    device=self.device)
                at = 0
                for qi in grp:
                    m = cand[qi].shape[0]
                    cols_q[qi] = cols[at:at + m]
                    at += m

        met = obs.metrics()
        reports: list[Report] = []
        for qi, (q, op) in enumerate(zip(queries, ops)):
            met.inc("session.queries")
            met.inc("session.queries_by_kind", kind="layer_coalesced")
            if obs.tracing_enabled():
                obs.instant("query", kind="layer", id=q.fingerprint(),
                            coalesced=True)
            sp = q.search
            cols = cols_q[qi]
            macs = float(op.total_macs)
            v = _objective_from_cols(cols, sp.objective, macs)
            v = np.where(np.isfinite(v), v, np.inf)
            order = np.lexsort((np.arange(len(v)), v))[:sp.top_k]
            maximize = sp.objective == "throughput"

            def actual(x: float) -> float:
                return -x if maximize else x

            top = [{"point": [int(g) for g in cand[qi][i]],
                    "value": actual(float(v[i])),
                    "stats": _stats_from_col(cols[i], macs)}
                   for i in order]
            u = uid_of[qi]
            reports.append(Report(
                kind="layer", name=op.name, objective=sp.objective,
                strategy=strat[qi], query=q.describe(), tag=q.tag,
                best=top[0], top_k=top,
                n_evaluated=int(cand[qi].shape[0]),
                n_devices=run.n_devices, coalesced=bool(coalesce),
                extras={"family_space": True, "uid": int(u),
                        "class_id": int(ns.class_of[u])},
                raw=FamilyBest(ns.unique[u], ns.spaces[u],
                               tuple(top[0]["point"]))))
            self.n_queries += 1
        return {"reports": reports, "n_compiles": run.n_compiles,
                "n_families": n_families, "compile_s": run.compile_s,
                "eval_s": run.eval_s, "encode_s": run.encode_s,
                "n_devices": run.n_devices}

    # ------------------------------------------------------------------
    # Queued submission
    # ------------------------------------------------------------------

    def submit(self, query: Query) -> PendingReport:
        """Queue a query for the next coalesced flush; returns a handle
        whose ``result()`` triggers the flush if still pending."""
        pending = PendingReport(self, query)
        self._queue.append((query, pending))
        return pending

    def flush(self, *, coalesce: bool = True) -> list[Report]:
        """Run every queued query in one :meth:`run_many` batch and
        resolve their handles."""
        if not self._queue:
            return []
        queue, self._queue = self._queue, []
        reports = self.run_many([q for q, _ in queue],
                                coalesce=coalesce)
        for (_, pending), rep in zip(queue, reports):
            pending._report = rep
        return reports


_DEFAULT: Session | None = None


def default_session() -> Session:
    """The shared module-level session ``mapspace.search``/``co_search``
    and ``netspace.search_network``/``co_search_network`` route through
    (lazy; one per process; its device is ``cuda`` unless a call names
    another)."""
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = Session()
    return _DEFAULT


def run(query: Query) -> Report:
    """One-shot convenience: ``repro_torch.api.run(query)`` on the
    default session."""
    return default_session().run(query)


def run_many(queries: Sequence[Query], **kw) -> list[Report]:
    """One-shot convenience: coalesced batch on the default session."""
    return default_session().run_many(queries, **kw)
