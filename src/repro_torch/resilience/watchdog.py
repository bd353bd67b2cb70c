"""Slow-chunk (straggler) detection.

The EWMA logic is ported from the seed's ``ft.coordinator``
(``FaultTolerantLoop._observe``) where it watched training steps; here it
watches device-chunk wall times in the sweep loops.  A chunk is *slow*
when its wall exceeds ``threshold ×`` the running EWMA; slow chunks are
flagged (``resilience.slow_chunks`` + a trace instant) and deliberately
do NOT update the EWMA, so one straggler cannot poison the baseline.
``ft.coordinator`` now delegates to this class, so the tree has exactly
one straggler detector.
"""
from __future__ import annotations

import threading

from .. import obs


class StragglerWatchdog:
    def __init__(self, threshold: float = 3.0, alpha: float = 0.2):
        self.threshold = threshold
        self.alpha = alpha
        self.ewma: float | None = None
        self.slow_count = 0
        self._lock = threading.Lock()

    def observe(self, wall_s: float, **labels) -> bool:
        """Record one chunk/step wall time; returns True when it was a
        straggler (> threshold × EWMA of non-straggler walls)."""
        with self._lock:
            if self.ewma is None:
                self.ewma = wall_s
                return False
            slow = wall_s > self.threshold * self.ewma
            if slow:
                self.slow_count += 1
            else:
                self.ewma = (1 - self.alpha) * self.ewma \
                    + self.alpha * wall_s
        if slow:
            obs.metrics().inc("resilience.slow_chunks")
            obs.instant("slow-chunk", wall_s=round(wall_s, 4),
                        ewma_s=round(self.ewma, 4), **labels)
        return slow


# Process-wide watchdog for the sweep chunk loops: chunk walls within one
# (op, block) regime are comparable, and a shared baseline is what makes
# a straggler stand out across many small evaluate calls.
CHUNK_WATCHDOG = StragglerWatchdog()
