"""The port's share of ``repro.obs``: the span tracer, request/phase
context and the metrics registry, stdlib only.

  * :func:`span` / :func:`instant` / :func:`enable_tracing` /
    :func:`save_trace` — a thread-safe span tracer emitting
    Chrome/Perfetto ``trace_event`` JSON; a no-op singleton when every
    sink is off (`trace.py`);
  * :func:`request_scope` / :func:`phase_scope` — contextvar-carried
    request ids and per-phase timing accumulation (`context.py`);
  * :func:`metrics` — the process-wide typed counter/gauge/histogram
    registry with a JSON ``snapshot()`` schema (`metrics.py`);
  * :func:`environment` — torch/CUDA artifact provenance (`env.py`).

Not ported yet (ROADMAP queue 1, item 4): the profiler hook
(``profile.py``), the crash flight recorder (``flightrec.py``) and the
Prometheus renderer (``prom.py``).
"""
from .context import (PHASE_NAMES, PHASE_OF_SPAN, PhaseBreakdown,
                      current_phases, current_request_ids,
                      new_request_id, phase_scope, request_scope,
                      timing_breakdown)
from .env import environment
from .metrics import (LATENCY_BUCKETS_S, SNAPSHOT_SCHEMA_VERSION,
                      Metrics, metrics)
from .trace import (NULL_SPAN, Tracer, current_tracer, disable_tracing,
                    enable_tracing, instant, save_trace, span,
                    tracing_enabled)

__all__ = [
    "LATENCY_BUCKETS_S", "Metrics", "NULL_SPAN", "PHASE_NAMES",
    "PHASE_OF_SPAN", "PhaseBreakdown", "SNAPSHOT_SCHEMA_VERSION", "Tracer",
    "current_phases", "current_request_ids", "current_tracer",
    "disable_tracing", "enable_tracing", "environment", "instant",
    "metrics",
    "new_request_id", "phase_scope", "request_scope", "save_trace", "span",
    "timing_breakdown", "tracing_enabled",
]
