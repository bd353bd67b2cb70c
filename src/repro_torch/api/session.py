"""The long-lived query engine behind the declarative front door — the
port of ``repro.api.session``, layer half.

A :class:`Session` owns what should outlive one query:

  * the on-disk RESULT cache (``cache_dir`` — ``mapspace.cache``, keyed
    by the full query fingerprint + engine schema version);
  * the device its queries run on (``cuda`` unless the caller names
    another; without a GPU a query raises instead of running elsewhere);
  * the resilience knobs (checkpoints, retry policy, degrade, faults).

The reference's session also owns a persistent XLA compilation cache
(``jax_cache_dir``).  The port compiles nothing — its evaluators are
eager PyTorch and hand-written kernels built once per process — so that
argument is gone.

``Session.run(query)`` routes one query to its engine.  This slice
answers the ``layer`` and ``layer_codse`` kinds; the ``network`` kinds,
``run_many`` (cross-query coalescing through netspace), ``submit`` and
``flush`` come with the port's netspace (ROADMAP queue 1, item 3) and
raise ``NotImplementedError`` until then.
"""
from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Any, Sequence

import torch

from .. import obs
from ..core.tensor_analysis import LayerOp
from ..devices import resolve_device
from ..resilience import (DeviceError, ReproError, ResilienceConfig,
                          SpecError, SweepKilled, cancel_scope, classify)
from .report import Report
from .spec import Query

LOG = logging.getLogger("repro_torch.resilience")

_NETSPACE = ("needs the port's netspace, not ported yet (ROADMAP queue 1, "
             "item 3)")


def _deadline_t(query: Query) -> float | None:
    """The query's ``deadline_s`` budget as an absolute monotonic
    deadline for :func:`~repro_torch.resilience.cancel_scope` (None = no
    budget)."""
    dl = query.search.deadline_s
    return None if dl is None else time.monotonic() + dl


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
        if kind.startswith("network"):
            raise NotImplementedError(f"{kind} queries {_NETSPACE}")
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
        stamp wins."""
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

    # ------------------------------------------------------------------
    # Cross-query batching: the port's netspace first
    # ------------------------------------------------------------------

    def run_many(self, queries: Sequence[Query], *,
                 coalesce: bool = True) -> list[Report]:
        """The reference coalesces a batch through netspace's shared
        family spaces; the port has no netspace yet."""
        raise NotImplementedError(f"Session.run_many {_NETSPACE}")

    def submit(self, query: Query):
        """Queued submission feeds :meth:`run_many`."""
        raise NotImplementedError(f"Session.submit {_NETSPACE}")

    def flush(self, *, coalesce: bool = True) -> list[Report]:
        """Queued submission feeds :meth:`run_many`."""
        raise NotImplementedError(f"Session.flush {_NETSPACE}")


_DEFAULT: Session | None = None


def default_session() -> Session:
    """The shared module-level session ``mapspace.search`` and
    ``co_search`` route through (lazy; one per process; its device is
    ``cuda`` unless a call names another)."""
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = Session()
    return _DEFAULT


def run(query: Query) -> Report:
    """One-shot convenience: ``repro_torch.api.run(query)`` on the
    default session."""
    return default_session().run(query)

