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

import dataclasses
import random
import time
import zlib

from .. import obs
from .errors import DeviceError, ReproError, is_oom
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
