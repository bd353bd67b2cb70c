"""The batch execution path of the serving tier — the port of
``repro.serve.coalescer.execute_batch``.

In the reference, the server's flush worker and the offline ``--file``
batch CLI both answer through :func:`execute_batch`, which is what makes
the offline run the oracle a coalesced server must answer bit-equal to.
The port has the offline half: ``repro_torch.launch.query --file`` calls
it.  The reference's ``Coalescer`` (the flush worker, its
deadline-or-batch-size trigger and its error isolation) comes with the
rest of the serving tier, ROADMAP queue 1, item 5.

Fault site (see ``resilience.faultinject``): ``serve-flush`` fires at the
head of every batch execution (``slow@serve-flush`` stretches a batch past
its deadline).
"""
from __future__ import annotations

from typing import Sequence

from ..api import Query, Report, Session
from ..resilience import cancel_scope, fault_point


def execute_batch(session: Session, queries: Sequence[Query], *,
                  coalesce: bool = True,
                  deadline_t: float | None = None) -> list[Report]:
    """THE batch execution path: ``--file`` batches (and, with the serving
    tier, server flushes) come through here, so their answers are
    bit-equal by construction.  ``deadline_t`` (absolute monotonic) bounds
    the whole pass via the engine's cooperative cancel scope."""
    fault_point("serve-flush")
    with cancel_scope(deadline_t):
        return session.run_many(list(queries), coalesce=coalesce)
