"""Lightweight span tracer emitting Chrome/Perfetto ``trace_event`` JSON
(the port's copy of ``repro.obs.trace``; the crash flight recorder is not
ported yet, so spans feed two sinks, not three).

One process-wide :class:`Tracer` (enabled on demand) collects *complete*
events (``"ph": "X"``) so a whole ``Session.run_many`` batch renders as a
timeline in ``chrome://tracing`` / https://ui.perfetto.dev: coalesce →
encode → device-pass chunks per device → top-k merge → DP compose.

Design constraints, in order:

  * **near-zero overhead when disabled** — the hot paths call
    :func:`span` unconditionally; with no tracer active it returns ONE
    shared no-op context manager (:data:`NULL_SPAN`), so the fast path
    allocates nothing and does no clock reads;
  * **thread-safe** — events append under a lock and carry the emitting
    thread id, so spans from worker threads land on their own timeline
    rows;
  * **self-contained output** — ``save()`` writes a valid Chrome
    ``trace_event`` file (``{"traceEvents": [...]}``) with the host's
    provenance in ``otherData``.
"""
from __future__ import annotations

import json
import os
import platform
import threading
import time
from typing import Any

from . import context as _context

__all__ = ["NULL_SPAN", "Tracer", "current_tracer", "disable_tracing",
           "enable_tracing", "instant", "save_trace", "span",
           "tracing_enabled"]

_PID = os.getpid()


class _NullSpan:
    """The disabled-tracer fast path: one shared, stateless context
    manager.  ``span()`` returns this exact singleton whenever tracing is
    off — zero allocation, zero clock reads (regression-tested in
    ``tests/test_obs.py``)."""
    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **args) -> None:
        """No-op counterpart of :meth:`_Span.set`."""


NULL_SPAN = _NullSpan()


class _Span:
    """One live span feeding up to two sinks on exit: the tracer (a
    complete ``"X"`` event, stamped with the current request ids) and the
    ambient :class:`~repro_torch.obs.context.PhaseBreakdown` (mapped span
    names accumulate into timing phases)."""
    __slots__ = ("_tracer", "name", "cat", "args", "_t0_pc")

    def __init__(self, tracer: "Tracer | None", name: str, cat: str,
                 args: dict[str, Any] | None):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args

    def __enter__(self) -> "_Span":
        self._t0_pc = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter()
        dur_s = t1 - self._t0_pc
        t = self._tracer
        if t is not None:
            args = self.args
            rids = _context.current_request_ids()
            if rids:
                args = dict(args) if args else {}
                args["rid"] = list(rids) if len(rids) > 1 else rids[0]
            t.emit(self.name, self.cat, (self._t0_pc - t._t0) * 1e6,
                   dur_s * 1e6, args)
        acc = _context.current_phases()
        if acc is not None:
            phase = _context.PHASE_OF_SPAN.get(self.name)
            if phase is not None:
                acc.add(phase, dur_s)
        return False

    def set(self, **args) -> None:
        """Attach/override args discovered while the span is open."""
        if self.args is None:
            self.args = {}
        self.args.update(args)


class Tracer:
    """Thread-safe in-memory collector of Chrome ``trace_event`` events.

    Timestamps are microseconds since the tracer was created
    (``perf_counter`` based), which is what the Chrome/Perfetto viewers
    expect of ``ts``/``dur``."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._events: list[dict[str, Any]] = []
        self._t0 = time.perf_counter()

    def now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    def emit(self, name: str, cat: str, ts_us: float, dur_us: float,
             args: dict[str, Any] | None = None) -> None:
        ev: dict[str, Any] = {
            "name": name, "cat": cat, "ph": "X", "pid": _PID,
            "tid": threading.get_ident(), "ts": round(ts_us, 3),
            "dur": round(max(dur_us, 0.0), 3)}
        if args:
            ev["args"] = args
        with self._lock:
            self._events.append(ev)

    def span(self, name: str, cat: str = "repro",
             args: dict[str, Any] | None = None) -> _Span:
        return _Span(self, name, cat, args)

    def emit_between(self, name: str, cat: str, t0_pc: float,
                     t1_pc: float,
                     args: dict[str, Any] | None = None) -> None:
        """Emit a complete event for a past ``perf_counter`` interval —
        retroactive spans like per-request queue wait, emitted at flush
        time from the enqueue timestamp."""
        self.emit(name, cat, (t0_pc - self._t0) * 1e6,
                  (t1_pc - t0_pc) * 1e6, args)

    def instant(self, name: str, cat: str = "repro",
                args: dict[str, Any] | None = None) -> None:
        ev: dict[str, Any] = {
            "name": name, "cat": cat, "ph": "i", "s": "t", "pid": _PID,
            "tid": threading.get_ident(), "ts": round(self.now_us(), 3)}
        if args:
            ev["args"] = args
        with self._lock:
            self._events.append(ev)

    # ------------------------------------------------------------------
    # Introspection / output
    # ------------------------------------------------------------------

    def events(self) -> list[dict[str, Any]]:
        with self._lock:
            return list(self._events)

    def spans(self, name: str | None = None) -> list[dict[str, Any]]:
        """Complete (``"X"``) events, optionally filtered by name."""
        return [e for e in self.events()
                if e["ph"] == "X" and (name is None or e["name"] == name)]

    def to_json(self) -> dict[str, Any]:
        """A complete Chrome ``trace_event`` document — load the saved
        file directly in ``chrome://tracing`` or Perfetto."""
        return {"traceEvents": self.events(),
                "displayTimeUnit": "ms",
                "otherData": {"python": platform.python_version(),
                              "platform": platform.platform(),
                              "host": platform.node(), "pid": _PID}}

    def save(self, path: str) -> str:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_json(), f)
        return path


# ----------------------------------------------------------------------
# Process-wide tracer (None = disabled; the common case)
# ----------------------------------------------------------------------

_TRACER: Tracer | None = None


def tracing_enabled() -> bool:
    return _TRACER is not None


def current_tracer() -> Tracer | None:
    return _TRACER


def enable_tracing() -> Tracer:
    """Install (or return the already-active) process tracer."""
    global _TRACER
    if _TRACER is None:
        _TRACER = Tracer()
    return _TRACER


def disable_tracing() -> Tracer | None:
    """Uninstall and return the active tracer (``None`` if none was)."""
    global _TRACER
    t, _TRACER = _TRACER, None
    return t


def span(name: str, cat: str = "repro", **args: Any):
    """Context manager timing one region.  THE instrumentation entry
    point: ``with span("compile", family=...):``.  Returns the shared
    no-op singleton when every sink is inactive — no tracer, no ambient
    phase accumulator — so cold hot-path calls stay zero-allocation."""
    t = _TRACER
    if t is None and _context.current_phases() is None:
        return NULL_SPAN
    return _Span(t, name, cat, args or None)


def instant(name: str, cat: str = "repro", **args: Any) -> None:
    """Zero-duration marker event (no-op when tracing is off)."""
    t = _TRACER
    if t is not None:
        targs = args or None
        rids = _context.current_request_ids()
        if rids:
            targs = dict(args)
            targs["rid"] = list(rids) if len(rids) > 1 else rids[0]
        t.instant(name, cat, targs)


def save_trace(path: str) -> str | None:
    """Write the active tracer's events as a Chrome trace file; returns
    the path, or ``None`` when tracing is disabled."""
    t = _TRACER
    if t is None:
        return None
    return t.save(path)
