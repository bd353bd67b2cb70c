"""Admission control and backpressure for the serving tier (the port's
copy of ``repro.serve.admission``).

Two gates, both decided BEFORE any engine work runs:

  * a bounded queue — at most ``max_queue`` admitted-but-unanswered
    requests; beyond that the server answers HTTP 429 with a
    ``Retry-After`` derived from the EWMA device-pass time (how long
    until a queue slot realistically frees up), so well-behaved clients
    back off instead of piling on;
  * a cost gate — :meth:`repro_torch.api.Query.estimated_cost` prices each
    query from its spec alone, and anything over ``max_cost`` is shed
    immediately (the co-DSE "grid bomb" a public endpoint must survive:
    a 100x100 hardware grid times a million-candidate budget would hold
    the device pipeline for minutes).

Shedding is cheap and explicit: ``serve.shed`` counts every 429 (with a
``serve.shed_detail[reason=...]`` breakdown), and the invariant
``serve.shed + serve.completed == serve.admitted`` is test-asserted — no
request admitted by this gate may ever vanish without a terminal
answer.
"""
from __future__ import annotations

import math
import threading

from .. import obs
from ..api import Query

# EWMA smoothing for the observed flush wall time (higher = snappier).
_ALPHA = 0.3


class AdmissionController:
    """Decides admit/shed for one server; thread-safe (HTTP handlers
    admit on the event loop, the flush worker reports wall times)."""

    def __init__(self, *, max_queue: int, max_cost: float | None):
        self.max_queue = int(max_queue)
        self.max_cost = None if max_cost is None else float(max_cost)
        self._lock = threading.Lock()
        self._ewma_flush_s = 0.05       # prior: one fast warm flush

    # -- decide --------------------------------------------------------

    def decide(self, query: Query, queue_depth: int) -> str | None:
        """None = admit; otherwise the shed reason (``"queue"`` /
        ``"cost"``)."""
        if queue_depth >= self.max_queue:
            return "queue"
        if self.max_cost is not None \
                and query.estimated_cost() > self.max_cost:
            return "cost"
        return None

    # -- backpressure hint ---------------------------------------------

    def note_flush(self, wall_s: float) -> None:
        """Fold one observed flush wall time into the EWMA the
        ``Retry-After`` hint is derived from."""
        with self._lock:
            self._ewma_flush_s += _ALPHA * (wall_s - self._ewma_flush_s)
        met = obs.metrics()
        met.gauge("serve.ewma_flush_s", round(self.ewma_flush_s, 4))
        met.observe_bucketed("serve.flush_s", wall_s)

    @property
    def ewma_flush_s(self) -> float:
        with self._lock:
            return self._ewma_flush_s

    def retry_after_s(self, queue_depth: int, max_batch: int) -> int:
        """Whole seconds until a retry is worth attempting: the queue's
        depth in flushes times the EWMA flush time, floored at 1s."""
        flushes = queue_depth / max(max_batch, 1) + 1.0
        return max(1, int(math.ceil(self.ewma_flush_s * flushes)))
