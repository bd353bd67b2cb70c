"""repro_torch.serve — the hardened DSE-as-a-service tier over ``Session``,
on PyTorch (the port of ``repro.serve``).

An asyncio HTTP/JSON server (wire format = ``examples/queries.json``
queries, answers = ``Report.to_json()``) with continuous cross-request
coalescing: concurrent clients' layer queries accumulate per
(op-class, level-count) family and flush into ONE padded gene-tensor
device pass on a deadline-or-batch-size trigger, on the session's device
(``cuda`` unless the session names another; the server raises at
construction without one).  Hardened end to end:

  * bounded admission queue + estimated-cost shedding (HTTP 429 with a
    ``Retry-After`` derived from the EWMA device-pass time);
  * per-request deadline budgets enforced cooperatively in the engine
    chunk loops — an expired request gets a terminal ``timeout``
    report, never a hang;
  * per-request isolation via ``Session``'s poisoned-batch fallback;
  * graceful draining shutdown (SIGTERM: stop admitting, persist the
    unanswered queue, flush in-flight families over sweep checkpoints)
    with bit-identical restart recovery;
  * ``/healthz`` ``/readyz`` ``/metricsz``, ``serve.*`` counters, and
    deterministic chaos drills (``slow@serve-flush``,
    ``crash@serve-worker``, ``kill@serve-drain``).
"""
from __future__ import annotations

from .admission import AdmissionController
from .coalescer import Coalescer, execute_batch
from .deadline import Deadline, batch_deadline_t
from .drain import (clear_pending, load_pending, pending_path,
                    persist_pending, recover, recovered_path,
                    save_observability)
from .loadgen import LoadgenResult, http_json, http_text, run_loadgen
from .server import DSEServer, ServeConfig

__all__ = [
    "AdmissionController", "Coalescer", "execute_batch",
    "Deadline", "batch_deadline_t",
    "clear_pending", "load_pending", "pending_path", "persist_pending",
    "recover", "recovered_path", "save_observability",
    "LoadgenResult", "http_json", "http_text", "run_loadgen",
    "DSEServer", "ServeConfig",
]
