"""Per-request deadline budgets for the serving tier (the port's copy of
``repro.serve.deadline``).

Every admitted request carries ONE wall-clock budget, fixed at
admission: ``search.deadline_s`` from the query itself, else the
server's default.  The budget is enforced in three places, outermost
wins:

  * the engine — :func:`repro_torch.resilience.cancel_scope` around the flush
    makes the chunk loops stop at the next chunk boundary
    (``BudgetExceeded`` → the whole flush answers with timeout reports);
  * the flush — requests already expired when their batch is picked up
    are answered ``where="queued"`` without any engine work;
  * the HTTP handler — an ``asyncio.wait_for`` backstop (budget plus a
    small grace for the in-flight chunk) guarantees the response socket
    NEVER hangs, whatever state the engine is in.

An expired request always gets a terminal ``kind="timeout"`` report
(:meth:`repro_torch.api.Report.timeout`), never a dropped connection.
"""
from __future__ import annotations

import dataclasses
import time

from ..api import Query, Report


@dataclasses.dataclass(frozen=True)
class Deadline:
    """One request's absolute budget: ``t`` is the monotonic expiry
    (None = unbounded), ``budget_s`` the original relative budget."""
    t: float | None
    budget_s: float | None

    @staticmethod
    def stamp(query: Query, default_s: float | None) -> "Deadline":
        budget = query.search.deadline_s
        if budget is None:
            budget = default_s
        t = None if budget is None else time.monotonic() + float(budget)
        return Deadline(t=t, budget_s=budget)

    def remaining(self) -> float | None:
        """Seconds left (may be negative); None when unbounded."""
        return None if self.t is None else self.t - time.monotonic()

    def expired(self) -> bool:
        return self.t is not None and time.monotonic() >= self.t

    def timeout_report(self, query: Query, *, where: str) -> Report:
        waited = 0.0 if self.t is None or self.budget_s is None else \
            time.monotonic() - (self.t - self.budget_s)
        return Report.timeout(query, deadline_s=self.budget_s,
                              waited_s=max(waited, 0.0), where=where)


def batch_deadline_t(deadlines: list[Deadline]) -> float | None:
    """The cancel-scope bound for one coalesced flush: the most patient
    member's expiry (an unbounded member keeps the flush unbounded —
    its work must be allowed to finish)."""
    ts = [d.t for d in deadlines]
    if not ts or any(t is None for t in ts):
        return None
    return max(ts)
