"""Retry policy for device passes.

A :class:`RetryPolicy` bounds how hard the chunk loops fight a failing
device pass before surfacing a :class:`~.errors.DeviceError`:

  * up to ``max_attempts`` total attempts per chunk, with exponential
    backoff and *deterministic* jitter (seeded from the label+attempt,
    so test runs are reproducible);
  * on OOM, up to ``max_splits`` recursive halvings of the chunk's block
    size (down to ``min_rows``) before falling back to plain retry;
  * ``chunk_deadline_s`` is an advisory per-chunk SLO: a device pass
    cannot be preempted, so a chunk that finishes over deadline is
    *flagged* (``resilience.deadline_exceeded``) rather than discarded —
    re-running a completed chunk would only add latency.
"""
from __future__ import annotations

import contextlib
import dataclasses
import random
import threading
import time
import zlib

from .. import obs
from .errors import BudgetExceeded, DeviceError, ReproError, is_oom
from .faultinject import SweepKilled


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    max_attempts: int = 3
    backoff_s: float = 0.05
    backoff_mult: float = 2.0
    jitter_frac: float = 0.25
    chunk_deadline_s: float | None = None
    max_splits: int = 4        # OOM block halvings before giving up
    min_rows: int = 64         # never split below this block size

    def backoff(self, attempt: int, salt: str = "") -> float:
        """Sleep before retry ``attempt`` (1-based); exponential with
        deterministic jitter."""
        base = self.backoff_s * self.backoff_mult ** (attempt - 1)
        rng = random.Random(zlib.crc32(f"{salt}:{attempt}".encode()))
        return base * (1.0 + self.jitter_frac * rng.random())

    def check_deadline(self, wall_s: float, **labels) -> bool:
        """Flag (never fail) a chunk that exceeded the per-chunk
        deadline; returns True when it did."""
        if self.chunk_deadline_s is None or wall_s <= self.chunk_deadline_s:
            return False
        obs.metrics().inc("resilience.deadline_exceeded")
        obs.instant("deadline-exceeded", wall_s=round(wall_s, 4),
                    deadline_s=self.chunk_deadline_s, **labels)
        return True


DEFAULT_POLICY = RetryPolicy()

# The process-wide policy the chunk loops fall back to when the caller
# does not pass one explicitly — Session(resilience=...) installs its
# RetryPolicy here so it reaches every device pass without threading a
# parameter through four layers of call sites.
_INSTALLED: RetryPolicy = DEFAULT_POLICY


def set_default_policy(policy: RetryPolicy | None) -> None:
    """Install ``policy`` as the process-wide default (None restores
    :data:`DEFAULT_POLICY`)."""
    global _INSTALLED
    _INSTALLED = policy or DEFAULT_POLICY


def default_policy() -> RetryPolicy:
    """The currently installed process-wide retry policy."""
    return _INSTALLED


# -- cooperative cancellation -------------------------------------------
#
# A device pass cannot be preempted, so deadlines are enforced *between*
# chunks: the session opens a cancel scope around a query and the chunk
# loops poll check_cancel() at each chunk boundary (next to the
# fault_point sites).  The scope is thread-local — one worker's deadline
# never leaks into another thread's sweep.

_CANCEL = threading.local()


@contextlib.contextmanager
def cancel_scope(deadline_t: float | None):
    """Bound all chunk work inside the ``with`` body by an absolute
    ``time.monotonic()`` deadline (None = no bound).  Scopes nest; the
    innermost-effective deadline is the minimum of the stack."""
    prev = getattr(_CANCEL, "deadline_t", None)
    if deadline_t is not None and prev is not None:
        deadline_t = min(deadline_t, prev)
    _CANCEL.deadline_t = deadline_t
    try:
        yield
    finally:
        _CANCEL.deadline_t = prev


def check_cancel(label: str = "chunk") -> None:
    """Raise :class:`BudgetExceeded` when the enclosing
    :func:`cancel_scope` deadline has passed.  Cheap enough to call at
    every chunk boundary; a no-op outside any scope."""
    deadline_t = getattr(_CANCEL, "deadline_t", None)
    if deadline_t is None:
        return
    over = time.monotonic() - deadline_t
    if over >= 0.0:
        obs.metrics().inc("resilience.cancelled_chunks")
        obs.instant("cancel", label=label, over_s=round(over, 4))
        # the flight recorder keeps the cancellation even when no tracer
        # is live — a postmortem dump shows WHERE the budget expired
        obs.flight_record("cancel", label, over_s=round(over, 4))
        raise BudgetExceeded(
            f"deadline expired {over:.3f}s ago at {label} boundary",
            budget="deadline_s")


def run_attempts(fn, *, policy: RetryPolicy, label: str,
                 first_exc: BaseException | None = None):
    """Run ``fn()`` under the retry budget.  ``first_exc`` counts a
    failure that already happened (the caller's in-line first attempt).
    :class:`SweepKilled` and already-classified :class:`ReproError`\\ s
    propagate immediately — a recursive recovery call has its own budget,
    and re-retrying its final error would multiply attempts."""
    met = obs.metrics()
    attempts = 1 if first_exc is not None else 0
    exc = first_exc
    while True:
        if exc is not None:
            if isinstance(exc, (SweepKilled, ReproError)):
                raise exc
            if attempts >= policy.max_attempts:
                raise DeviceError(
                    f"{label}: failed after {attempts} attempts "
                    f"({type(exc).__name__}: "
                    f"{str(exc).strip().splitlines()[0] if str(exc) else ''})",
                    attempts=attempts, oom=is_oom(exc)) from exc
            met.inc("resilience.retries")
            obs.instant("retry", label=label, attempt=attempts)
            time.sleep(policy.backoff(attempts, salt=label))
        attempts += 1
        try:
            return fn()
        except Exception as e:    # noqa: BLE001 — classified above
            exc = e
