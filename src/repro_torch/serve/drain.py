"""Graceful draining shutdown and crash recovery for the serving tier
(the port's copy of ``repro.serve.drain``).

The drain contract (SIGTERM):

  1. stop admitting (``/readyz`` flips to 503; new queries answer 429);
  2. PERSIST every admitted-but-unanswered request to
     ``serve-pending.json`` (atomic tmp + ``os.replace``, same commit
     protocol as ``sweepckpt``) — in wire format, so the file
     round-trips through :meth:`repro_torch.api.Query.from_json`;
  3. flush the in-flight families — under the session's checkpoint
     directory, so a kill mid-drain leaves resumable
     ``sweep-batch-*`` checkpoints behind (``kill@serve-drain`` fires
     between steps 2 and 3: the deterministic chaos drill for exactly
     that death);
  4. on a CLEAN drain, delete the pending file and exit.

Recovery (server start): a surviving ``serve-pending.json`` means the
previous process died owing answers.  The queries are re-executed
through the same :func:`~repro_torch.serve.coalescer.execute_batch` path —
identical fingerprints find the identical sweep checkpoints, so the
re-run resumes bit-identically — and their deterministic result slices
are written to ``serve-recovered.json`` (the artifact the tests compare
against the offline oracle).  The original clients are gone; the warm
evaluators, result caches, and recovered artifact are what survives.
"""
from __future__ import annotations

import json
import logging
import os
from typing import Any

from .. import obs
from ..api import Query, Session

LOG = logging.getLogger("repro_torch.serve")

PENDING_NAME = "serve-pending.json"
RECOVERED_NAME = "serve-recovered.json"
TRACE_NAME = "serve-trace.json"
METRICS_NAME = "serve-metrics.json"


def pending_path(ckpt_dir: str) -> str:
    return os.path.join(ckpt_dir, PENDING_NAME)


def recovered_path(ckpt_dir: str) -> str:
    return os.path.join(ckpt_dir, RECOVERED_NAME)


def _atomic_write_json(path: str, payload: Any) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=1)
    os.replace(tmp, path)


def save_observability(out_dir: str,
                       metrics_snapshot: dict) -> dict[str, str | None]:
    """Flush the observability state as part of the drain: the active
    tracer's events (``serve-trace.json`` — previously lost on SIGTERM,
    the tracer only ever saved on CLI exit) and a final metrics
    snapshot (``serve-metrics.json``).  Returns the written paths
    (trace is None when tracing is off)."""
    os.makedirs(out_dir, exist_ok=True)
    trace_path = obs.save_trace(os.path.join(out_dir, TRACE_NAME))
    metrics_path = os.path.join(out_dir, METRICS_NAME)
    _atomic_write_json(metrics_path, metrics_snapshot)
    obs.instant("serve-obs-saved", trace=bool(trace_path))
    return {"trace": trace_path, "metrics": metrics_path}


def persist_pending(ckpt_dir: str, raw_queries: list[dict]) -> str:
    """Step 2 of the drain: commit the unanswered queue to disk BEFORE
    the final flush, so a kill mid-drain loses nothing."""
    path = pending_path(ckpt_dir)
    _atomic_write_json(path, {"queries": raw_queries})
    obs.metrics().inc("serve.drained_queries", len(raw_queries))
    obs.instant("serve-drain-persist", path=path, n=len(raw_queries))
    return path


def clear_pending(ckpt_dir: str) -> None:
    try:
        os.remove(pending_path(ckpt_dir))
    except OSError:
        pass


def load_pending(ckpt_dir: str) -> list[dict]:
    """The previous process's unanswered queue ([] = clean shutdown).
    A corrupt file is quarantined and treated as empty — recovery must
    never block a restart."""
    path = pending_path(ckpt_dir)
    if not os.path.exists(path):
        return []
    try:
        with open(path) as f:
            payload = json.load(f)
        return list(payload.get("queries", []))
    except (OSError, ValueError) as e:
        LOG.warning("corrupt %s (%s: %s) — quarantined, skipping "
                    "recovery", path, type(e).__name__, e)
        obs.metrics().inc("serve.recover_corrupt")
        try:
            os.replace(path, path + ".corrupt")
        except OSError:
            pass
        return []


def recover(session: Session, ckpt_dir: str, *,
            coalesce: bool = True) -> int:
    """Re-execute the previous process's unanswered queue (if any);
    returns how many queries were recovered.  Runs synchronously at
    server start — the checkpoints make it cheap, and ``/readyz`` does
    not flip to ready until the debt is paid."""
    from .coalescer import execute_batch
    raw = load_pending(ckpt_dir)
    if not raw:
        return 0
    met = obs.metrics()
    queries = [Query.from_json(d) for d in raw]
    LOG.warning("recovering %d unanswered quer%s from %s",
                len(queries), "y" if len(queries) == 1 else "ies",
                pending_path(ckpt_dir))
    reports = execute_batch(session, queries, coalesce=coalesce)
    _atomic_write_json(
        recovered_path(ckpt_dir),
        {"reports": [r.results_json() for r in reports]})
    clear_pending(ckpt_dir)
    met.inc("serve.recovered", len(queries))
    obs.instant("serve-recover", n=len(queries))
    return len(queries)
