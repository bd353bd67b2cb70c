"""Typed counters, gauges, and histograms for the search stack.

One process-wide :class:`Metrics` registry (``metrics()``) collects the
quantities the engine already *computes* but never *kept*: compiles per
(op-class, level-count) family, warm-executable and result-cache
hit/miss, genes evaluated, chunk occupancy, per-device dispatch time,
bytes shipped across the top-k merge.  Everything is thread-safe and
cheap (a dict update under a lock, at chunk — not row — granularity).

``snapshot()`` returns a plain JSON-serializable dict with its own
schema version; ``Report.bench`` and the query CLI embed it in BENCH_*
artifacts and ``--out`` payloads so CI asserts budgets from ONE
structured snapshot instead of grepping stdout.

Label convention: a metric instance is keyed ``name[k=v,...]`` with
labels sorted, e.g. ``universal.compiles_by_family[family=conv1:L2]``.
"""
from __future__ import annotations

import bisect
import threading
from typing import Any

__all__ = ["LATENCY_BUCKETS_S", "Metrics", "SNAPSHOT_SCHEMA_VERSION",
           "metrics"]

# Version of the dict layout returned by ``Metrics.snapshot``.  Still 1:
# the bucketed-histogram block is additive (new top-level key), every
# existing reader keeps working.
SNAPSHOT_SCHEMA_VERSION = 1

# Default fixed buckets (seconds) for SLO latency histograms: log-spaced
# from sub-ms warm phases to multi-minute cold compiles.  Fixed across
# the fleet so histograms aggregate by simple vector addition.
LATENCY_BUCKETS_S = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                     0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0)


def _key(name: str, labels: dict[str, Any]) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}[{inner}]"


class _Hist:
    """Streaming summary of one histogram: count/total/min/max."""
    __slots__ = ("count", "total", "min", "max")

    def __init__(self) -> None:
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = float("-inf")

    def observe(self, v: float) -> None:
        self.count += 1
        self.total += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    def summary(self) -> dict[str, float]:
        return {"count": self.count, "total": self.total,
                "min": self.min if self.count else 0.0,
                "max": self.max if self.count else 0.0,
                "mean": (self.total / self.count) if self.count else 0.0}


class _BucketHist:
    """Fixed-bucket cumulative histogram (Prometheus ``le`` semantics:
    a value lands in the first bucket whose upper bound is >= it) with
    one exemplar — the last ``(request_id, value)`` — per bucket."""
    __slots__ = ("buckets", "counts", "count", "total", "exemplars")

    def __init__(self, buckets: tuple[float, ...]) -> None:
        self.buckets = tuple(float(b) for b in buckets)
        self.counts = [0] * (len(self.buckets) + 1)   # last = +Inf
        self.count = 0
        self.total = 0.0
        self.exemplars: dict[int, dict[str, Any]] = {}

    def observe(self, v: float, exemplar: str | None = None) -> None:
        i = bisect.bisect_left(self.buckets, v)
        self.counts[i] += 1
        self.count += 1
        self.total += v
        if exemplar is not None:
            self.exemplars[i] = {"request_id": str(exemplar),
                                 "value": v}

    def summary(self) -> dict[str, Any]:
        bounds = [*self.buckets, "+Inf"]
        cum, rows = 0, []
        for le, n in zip(bounds, self.counts):
            cum += n
            rows.append([le, cum])
        ex = {str(bounds[i]): e
              for i, e in sorted(self.exemplars.items())}
        return {"count": self.count, "total": self.total,
                "buckets": rows, "exemplars": ex}


class Metrics:
    """Thread-safe registry of counters (monotonic), gauges (last value),
    streaming histograms (count/total/min/max/mean), and fixed-bucket
    SLO histograms with per-bucket exemplars."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: dict[str, float] = {}
        self._gauges: dict[str, float] = {}
        self._hists: dict[str, _Hist] = {}
        self._bucket_hists: dict[str, _BucketHist] = {}

    # -- counters ------------------------------------------------------

    def inc(self, name: str, value: float = 1.0, **labels: Any) -> float:
        """Add ``value`` to a counter; returns the new total."""
        k = _key(name, labels)
        with self._lock:
            v = self._counters.get(k, 0.0) + value
            self._counters[k] = v
        return v

    def value(self, name: str, **labels: Any) -> float:
        """Current counter total (0.0 when never incremented)."""
        with self._lock:
            return self._counters.get(_key(name, labels), 0.0)

    def counters(self, prefix: str = "") -> dict[str, float]:
        """Counters whose key starts with ``prefix`` (all by default)."""
        with self._lock:
            return {k: v for k, v in self._counters.items()
                    if k.startswith(prefix)}

    # -- gauges --------------------------------------------------------

    def gauge(self, name: str, value: float, **labels: Any) -> None:
        with self._lock:
            self._gauges[_key(name, labels)] = value

    def gauge_value(self, name: str, default: float = 0.0,
                    **labels: Any) -> float:
        """Current gauge value (``default`` when never set) — the read
        half of read-modify-write gauge maintenance (callers supply
        their own outer lock for atomicity, e.g. mapspace.cache's
        occupancy accounting)."""
        with self._lock:
            return self._gauges.get(_key(name, labels), default)

    # -- histograms ----------------------------------------------------

    def observe(self, name: str, value: float, **labels: Any) -> None:
        k = _key(name, labels)
        with self._lock:
            h = self._hists.get(k)
            if h is None:
                h = self._hists[k] = _Hist()
            h.observe(float(value))

    def observe_bucketed(self, name: str, value: float, *,
                         buckets: tuple[float, ...] = LATENCY_BUCKETS_S,
                         exemplar: str | None = None,
                         **labels: Any) -> None:
        """Record into a fixed-bucket SLO histogram.  ``exemplar`` (a
        request id) is kept as the bucket's last exemplar and rides into
        the Prometheus exposition."""
        k = _key(name, labels)
        with self._lock:
            h = self._bucket_hists.get(k)
            if h is None:
                h = self._bucket_hists[k] = _BucketHist(buckets)
            h.observe(float(value), exemplar)

    # -- snapshot ------------------------------------------------------

    def snapshot(self) -> dict[str, Any]:
        """JSON-serializable view of every metric.  Counters that hold
        integral totals serialize as ints so ``==`` asserts in CI read
        naturally."""
        with self._lock:
            counters = {k: (int(v) if float(v).is_integer() else v)
                        for k, v in sorted(self._counters.items())}
            gauges = dict(sorted(self._gauges.items()))
            hists = {k: h.summary()
                     for k, h in sorted(self._hists.items())}
            bucket_hists = {k: h.summary()
                            for k, h in sorted(self._bucket_hists.items())}
        return {"schema_version": SNAPSHOT_SCHEMA_VERSION,
                "counters": counters, "gauges": gauges,
                "histograms": hists, "bucket_histograms": bucket_hists}

    def reset(self) -> None:
        """Drop every metric.  Test-only: the process registry backs
        ``universal.compile_count()``, whose parity with the warmed-key
        set must hold for the life of the process — never reset the
        global registry outside an isolated test ``Metrics()``."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()
            self._bucket_hists.clear()


# Process-wide registry.  Always on: recording a counter is a dict update
# under a lock, at chunk granularity — there is no "disabled" mode to
# keep semantics (e.g. compile_count parity) unconditional.
_METRICS = Metrics()


def metrics() -> Metrics:
    """The process-wide metrics registry."""
    return _METRICS
