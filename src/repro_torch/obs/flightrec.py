"""Always-on crash flight recorder: a bounded lock-free ring of recent
spans/events/errors that dumps to ``flight-<ts>.json`` on unhandled
handler errors, serve fault drills, SIGQUIT, and timeout reports (the
port's copy of ``repro.obs.flightrec``: the same entries and the same dump
keys, with torch/CUDA provenance of the run's device).

The RING is lock-free by construction: ``itertools.count().__next__``
hands out monotonically increasing sequence numbers (a single C-level
call — atomic under the GIL), and each writer stores its finished entry
dict at ``seq % capacity`` with one list item assignment (also atomic).
Readers snapshot the ring without coordination; a concurrently
overwritten slot yields either the old or the new complete entry, never
a torn one.  Dump bookkeeping is COLD path and takes a real lock:
``maybe_dump``'s rate-limit check-then-stamp must be atomic or
concurrent timeout storms double-dump.

Recording is cheap enough to stay on unconditionally for events and
errors.  *Span* capture (every ``obs.span`` exit feeding the ring) is
opt-in via :func:`enable_flight_spans` — the server turns it on at
start so postmortem dumps carry the failing request's engine spans,
while offline CLI hot paths keep the zero-allocation ``NULL_SPAN``
fast path.
"""
from __future__ import annotations

import itertools
import json
import os
import threading
import time
from typing import TYPE_CHECKING, Any

from . import context as _context

if TYPE_CHECKING:
    import torch

__all__ = [
    "DEFAULT_CAPACITY",
    "FlightRecorder",
    "default_flight_dir",
    "dump_flight",
    "enable_flight_spans",
    "flight_record",
    "flight_recorder",
    "flight_spans_enabled",
]

DEFAULT_CAPACITY = 2048

# Span capture into the ring: module global read on the span fast path.
_SPANS_ON = False


class FlightRecorder:
    """Bounded ring of recent observability entries + crash dumper."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY) -> None:
        self.capacity = max(int(capacity), 8)
        self._slots: list[dict | None] = [None] * self.capacity
        self._next = itertools.count().__next__   # atomic in CPython
        self._dump_count = itertools.count(1).__next__
        # dump bookkeeping is COLD path and lock-guarded: the rate-limit
        # check-then-stamp in maybe_dump() must be atomic or concurrent
        # timeout storms double-dump past min_interval_s
        self._dump_lock = threading.Lock()
        self._last_dump_t = 0.0

    # -- recording (hot path, lock-free) -------------------------------

    def record(self, kind: str, name: str, /, **fields: Any) -> None:
        """Append one entry.  ``kind`` is ``span``/``event``/``error``/
        ``cancel``; the current request ids attach automatically.
        Positional-only so span args may themselves carry ``kind``/
        ``name`` keys (the structural keys win on collision)."""
        entry: dict[str, Any] = {
            "seq": 0,                      # patched below, keep key first
            "t": time.time(),
            "kind": kind,
            "name": name,
            "thread": threading.current_thread().name,
        }
        rids = _context.current_request_ids()
        if rids:
            entry["rid"] = list(rids) if len(rids) > 1 else rids[0]
        for k, v in fields.items():
            entry.setdefault(k, v)
        seq = self._next()
        entry["seq"] = seq
        self._slots[seq % self.capacity] = entry

    # -- reading / dumping ---------------------------------------------

    def entries(self) -> list[dict]:
        """Snapshot of surviving entries, oldest first."""
        out = [e for e in list(self._slots) if e is not None]
        out.sort(key=lambda e: e["seq"])
        return out

    def dump(self, out_dir: str, reason: str, *,
             device: "str | torch.device | None" = None,
             **info: Any) -> str:
        """Write the ring to ``flight-<ts>-<pid>-<n>.json``; returns the
        path.  ``environment`` is the provenance of ``device``, the device
        the dumping program runs on (``cuda`` unless it names another, by
        the port's device rule).  Never raises into the caller's crash
        path by design — callers wrap it — but the write itself is
        straightforward."""
        from .env import environment
        from .metrics import metrics
        os.makedirs(out_dir, exist_ok=True)
        stamp = time.strftime("%Y%m%dT%H%M%S", time.gmtime())
        path = os.path.join(
            out_dir,
            f"flight-{stamp}-{os.getpid()}-{self._dump_count()}.json")
        payload = {
            "reason": reason,
            "dumped_at": time.time(),
            **info,
            "environment": environment(device),
            "entries": self.entries(),
        }
        with open(path, "w") as f:
            json.dump(payload, f, indent=1, default=str)
        with self._dump_lock:
            self._last_dump_t = time.monotonic()
        metrics().inc("flight.dumps", reason=reason)
        return path

    def maybe_dump(self, out_dir: str, reason: str,
                   min_interval_s: float = 5.0, *,
                   device: "str | torch.device | None" = None,
                   **info: Any) -> str | None:
        """Rate-limited dump for recurring triggers (timeout storms).
        The check-then-stamp is atomic: of N threads racing past the
        interval, exactly one dumps (the stamp is claimed up front and
        rolled back only if the dump itself fails)."""
        with self._dump_lock:
            now = time.monotonic()
            if now - self._last_dump_t < min_interval_s:
                return None
            prev, self._last_dump_t = self._last_dump_t, now
        try:
            return self.dump(out_dir, reason, device=device, **info)
        except BaseException:
            with self._dump_lock:
                self._last_dump_t = prev   # failed claim: allow a retry
            raise


_RECORDER = FlightRecorder()


def flight_recorder() -> FlightRecorder:
    """The process-wide flight recorder (always on)."""
    return _RECORDER


def flight_record(kind: str, name: str, /, **fields: Any) -> None:
    _RECORDER.record(kind, name, **fields)


def dump_flight(out_dir: str, reason: str, *,
                device: "str | torch.device | None" = None,
                **info: Any) -> str:
    return _RECORDER.dump(out_dir, reason, device=device, **info)


def enable_flight_spans(on: bool = True) -> None:
    """Feed every ``obs.span`` exit (and instant) into the ring.  The
    server enables this at start; offline CLIs keep the null fast path."""
    global _SPANS_ON
    _SPANS_ON = bool(on)


def flight_spans_enabled() -> bool:
    return _SPANS_ON


def default_flight_dir() -> str:
    """Dump directory when none is configured: ``$REPRO_TORCH_FLIGHT_DIR``
    or the system temp dir.  (The port reads a variable of its own, so
    its dumps and the JAX package's never share a directory by
    accident.)"""
    import tempfile
    return os.environ.get("REPRO_TORCH_FLIGHT_DIR") or tempfile.gettempdir()
