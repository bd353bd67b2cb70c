"""Request-scoped observability context.

Two :mod:`contextvars` carry per-request state from the serve handler
through the coalescer's flush thread into the engine chunk loops:

  * the **request-id scope** — the set of request ids whose work is
    currently executing.  The server mints one per ``POST /query``
    (honoring an inbound ``X-Request-Id``); a coalesced flush opens one
    scope holding *all* member ids, so every engine span/flight entry
    recorded inside is attributable to the exact requests that rode
    that device pass.
  * the **phase accumulator** — a thread-safe per-phase seconds sink.
    ``Session.run`` / ``run_many`` open a fresh one per query (or per
    coalesced family batch); span exits add their duration to the
    mapped timing phase, and the snapshot becomes the ``timing``
    breakdown stamped on every ``Report``.

Both are contextvars, NOT thread-locals: the coalescer's single flush
worker opens the scopes *inside* the worker thread, and everything the
engines do on that thread inherits them.
"""
from __future__ import annotations

import contextlib
import contextvars
import threading
import uuid

__all__ = [
    "PHASE_NAMES",
    "PHASE_OF_SPAN",
    "PhaseBreakdown",
    "current_phases",
    "current_request_ids",
    "new_request_id",
    "phase_scope",
    "request_scope",
    "timing_breakdown",
]

_REQUEST_IDS: contextvars.ContextVar[tuple[str, ...]] = \
    contextvars.ContextVar("repro_request_ids", default=())
_PHASES: contextvars.ContextVar["PhaseBreakdown | None"] = \
    contextvars.ContextVar("repro_phase_acc", default=None)

# Span name -> timing phase.  Only LEAF spans are mapped (the phases
# must be disjoint wall-time intervals so they can sum to wall latency);
# container spans (``query``, ``run_many``, ``flush``, ``design-chunk``)
# stay unmapped or they would double-count their children.
PHASE_OF_SPAN = {
    "coalesce": "coalesce_wait",
    "encode": "encode",
    "compile": "compile",
    "dispatch": "device_pass",
    "device-pass": "device_pass",
    "warmup": "compile",
    "topk-merge": "merge",
    "compose": "merge",
}

# Canonical phase order for the ``timing`` breakdown.  ``queue_wait`` is
# server-side (enqueue -> flush start); ``other`` is the residual that
# makes the phases sum to measured wall latency by construction.
PHASE_NAMES = ("queue_wait", "coalesce_wait", "encode", "compile",
               "device_pass", "merge", "other")


def new_request_id() -> str:
    """A fresh 16-hex-char request id."""
    return uuid.uuid4().hex[:16]


def current_request_ids() -> tuple[str, ...]:
    """Request ids whose work is executing in this context (may be
    several: a coalesced flush carries all member ids)."""
    return _REQUEST_IDS.get()


@contextlib.contextmanager
def request_scope(*rids: str):
    """Attribute everything inside to ``rids`` (spans, flight entries)."""
    token = _REQUEST_IDS.set(tuple(rids))
    try:
        yield
    finally:
        _REQUEST_IDS.reset(token)


class PhaseBreakdown:
    """Thread-safe accumulator of per-phase seconds for one unit of
    engine work (one ``Session.run`` or one coalesced family batch)."""

    __slots__ = ("_lock", "_phases")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._phases: dict[str, float] = {}

    def add(self, phase: str, seconds: float) -> None:
        with self._lock:
            self._phases[phase] = self._phases.get(phase, 0.0) + seconds

    def snapshot(self) -> dict[str, float]:
        with self._lock:
            return dict(self._phases)


def current_phases() -> PhaseBreakdown | None:
    return _PHASES.get()


@contextlib.contextmanager
def phase_scope(acc: PhaseBreakdown | None = None):
    """Route mapped span durations into ``acc`` (fresh one if None)."""
    acc = acc if acc is not None else PhaseBreakdown()
    token = _PHASES.set(acc)
    try:
        yield acc
    finally:
        _PHASES.reset(token)


def timing_breakdown(wall_s: float, phases: dict[str, float],
                     request_id: str | None = None) -> dict:
    """The ``Report.extras['timing']`` payload.

    ``other`` is the residual ``wall - sum(mapped phases)``, so the
    phases sum to the measured wall latency exactly (up to rounding).
    Engine phases can never exceed wall: they are disjoint sub-intervals
    of the same measurement window.
    """
    wall = round(max(0.0, wall_s), 6)
    out = {p: round(v, 6) for p, v in sorted(phases.items())
           if p != "other" and v > 0.0}
    out["other"] = round(max(0.0, wall - sum(out.values())), 6)
    doc: dict = {"wall_s": wall, "phases": out}
    if request_id is not None:
        doc["request_id"] = request_id
    return doc
