"""Structured error taxonomy for the search stack.

Every failure a ``Query`` can surface is one of a handful of typed,
one-line errors instead of a deep XLA traceback:

  ReproError                 base (carries a ``details`` dict)
    SpecError                invalid Query/Workload/Hardware/SearchSpec
                             field (also a ValueError, so existing
                             ``pytest.raises(ValueError)`` call sites and
                             try/except blocks keep working)
    DeviceError              a device pass failed after the retry budget
                             (also a RuntimeError)
    CacheError               corrupt/unreadable result cache or sweep
                             checkpoint (always recoverable: the file is
                             quarantined and treated as a miss)
    BudgetExceeded           a wall-time / deadline budget was exhausted

``classify`` wraps an arbitrary exception into this taxonomy at the
``Session.run`` boundary; ``is_oom`` is the single place that decides
whether an exception means "out of device memory" (and therefore that
halving the chunk is worth trying before giving up).

Stdlib-only on purpose: importable from ``api.spec`` / ``mapspace.cache``
without cycles.
"""
from __future__ import annotations


class ReproError(Exception):
    """Base of the structured error taxonomy; ``details`` holds
    machine-readable context (offending field, attempts, chunk index)."""

    def __init__(self, message: str, **details):
        super().__init__(message)
        self.details = details

    def one_line(self) -> str:
        d = ", ".join(f"{k}={v}" for k, v in self.details.items())
        return f"{type(self).__name__}: {self} ({d})" if d else \
            f"{type(self).__name__}: {self}"


class SpecError(ReproError, ValueError):
    """A Query/Workload/Hardware/SearchSpec field is invalid; raised at
    construction so bad specs never reach gene encoding."""

    def __init__(self, message: str, *, field: str, **details):
        super().__init__(message, field=field, **details)
        self.field = field


class DeviceError(ReproError, RuntimeError):
    """A device pass kept failing after retries/splits were exhausted."""


class CacheError(ReproError):
    """A persisted artifact (result cache entry, sweep checkpoint) was
    corrupt.  Never fatal: callers quarantine the file and recompute."""


class BudgetExceeded(ReproError, RuntimeError):
    """A wall-time or per-chunk deadline budget was exhausted."""


_OOM_MARKERS = ("resource_exhausted", "out of memory", "oom",
                "failed to allocate")


def is_oom(exc: BaseException) -> bool:
    """Whether ``exc`` looks like device memory exhaustion — the one
    failure where shrinking the chunk (rather than plain retry) helps."""
    msg = f"{type(exc).__name__}: {exc}".lower()
    return any(m in msg for m in _OOM_MARKERS)


def classify(exc: BaseException, *, context: str = "") -> ReproError:
    """Wrap an arbitrary exception as a :class:`ReproError` for the Query
    boundary.  Already-classified errors pass through unchanged."""
    if isinstance(exc, ReproError):
        return exc
    kind = type(exc).__name__
    # first line only: XLA errors carry multi-KB tracebacks in str()
    msg = str(exc).strip().splitlines()[0] if str(exc).strip() else kind
    prefix = f"{context}: " if context else ""
    if is_oom(exc):
        return DeviceError(f"{prefix}device out of memory ({msg})",
                           cause=kind)
    if isinstance(exc, (ValueError, TypeError, KeyError)):
        return SpecError(f"{prefix}{msg}", field="unknown", cause=kind)
    return DeviceError(f"{prefix}{msg}", cause=kind)
