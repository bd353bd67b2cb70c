"""repro_torch.obs — tracing, metrics, and profiling spine of the port
(the port of ``repro.obs``), stdlib only but for the torch profiler hook
and the provenance block:

  * :func:`span` / :func:`enable_tracing` / :func:`save_trace` — a
    thread-safe span tracer emitting Chrome/Perfetto ``trace_event``
    JSON; a no-op singleton when every sink is off (`trace.py`);
  * :func:`request_scope` / :func:`phase_scope` — contextvar-carried
    request ids and per-phase timing accumulation, threading one
    request's identity from the serve handler through the coalescer
    into the engine chunk loops (`context.py`);
  * :func:`metrics` — the process-wide typed counter/gauge/histogram
    registry with a JSON ``snapshot()`` schema plus fixed-bucket SLO
    histograms with request-id exemplars (`metrics.py`), renderable in
    Prometheus text format via :func:`prometheus_text` (`prom.py`);
  * :func:`flight_record` / :func:`dump_flight` — the always-on crash
    flight recorder: a bounded lock-free ring of recent spans/events/
    errors dumped to ``flight-<ts>.json`` on crashes (`flightrec.py`);
  * :func:`environment` / :func:`profile_to` — torch/CUDA artifact
    provenance and the opt-in ``torch.profiler`` hook (`env.py`,
    `profile.py`).
"""
from .context import (PHASE_NAMES, PHASE_OF_SPAN, PhaseBreakdown,
                      current_phases, current_request_ids,
                      new_request_id, phase_scope, request_scope,
                      timing_breakdown)
from .env import environment
from .flightrec import (FlightRecorder, default_flight_dir, dump_flight,
                        enable_flight_spans, flight_record,
                        flight_recorder, flight_spans_enabled)
from .metrics import (LATENCY_BUCKETS_S, SNAPSHOT_SCHEMA_VERSION,
                      Metrics, metrics)
from .profile import profile_to
from .prom import prometheus_text
from .trace import (NULL_SPAN, Tracer, current_tracer, disable_tracing,
                    enable_tracing, instant, save_trace, span,
                    tracing_enabled)

__all__ = [
    "FlightRecorder", "LATENCY_BUCKETS_S", "Metrics", "NULL_SPAN",
    "PHASE_NAMES", "PHASE_OF_SPAN", "PhaseBreakdown",
    "SNAPSHOT_SCHEMA_VERSION", "Tracer", "current_phases",
    "current_request_ids", "current_tracer", "default_flight_dir",
    "disable_tracing", "dump_flight", "enable_flight_spans",
    "enable_tracing", "environment", "flight_record", "flight_recorder",
    "flight_spans_enabled", "instant", "metrics", "new_request_id",
    "phase_scope", "profile_to", "prometheus_text", "request_scope",
    "save_trace", "span", "timing_breakdown", "tracing_enabled",
]
