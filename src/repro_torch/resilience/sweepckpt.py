"""Compact, atomic sweep checkpoints for resumable chunk loops.

One checkpoint = one ``.npz`` file holding the sweep's running
accumulator state (chunk cursor, top-k entries, Pareto candidates,
partial value columns) plus a JSON ``meta`` guard (query fingerprint /
cache key, row count, chunking parameters).  The commit protocol is the
dormant ``checkpoint.Checkpointer``'s, adapted from a per-step directory
tree down to a single file: write to a temp path, ``os.replace`` to
commit — a crash mid-save never corrupts the previous checkpoint.

Robustness contract (mirrors ``mapspace.cache``): a truncated or
otherwise unreadable checkpoint is a *miss*, never a crash — the file is
quarantined to ``<path>.corrupt``, ``resilience.checkpoint_corrupt`` is
bumped, and the sweep restarts from chunk 0.  A readable checkpoint
whose ``meta`` guard doesn't match the current call (different genes,
block size, or device count — chunk boundaries would differ) is silently
discarded the same way, minus the quarantine.

Resume is bit-exact by construction: the chunk loops collect results in
deterministic dispatch order, the saved accumulators are restored
verbatim (float64/float32 round-trip exactly through ``.npz``), and the
final top-k sort / Pareto refinement are order-insensitive merges.
"""
from __future__ import annotations

import json
import logging
import os
import re
import time
import zipfile

import numpy as np

from .. import obs
from .faultinject import fault_point

LOG = logging.getLogger("repro.resilience")

_META_KEY = "__meta_json__"


def _sanitize(key: str) -> str:
    return re.sub(r"[^A-Za-z0-9._-]", "_", key)[:120]


def array_hash(*arrays) -> str:
    """Order-sensitive content hash of input arrays — the genes/hardware
    part of a checkpoint's meta guard."""
    import hashlib
    h = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()[:24]


class SweepCheckpoint:
    """Periodic saver/loader for one sweep's accumulator state."""

    def __init__(self, directory: str, key: str, *,
                 every_chunks: int = 4, every_s: float = 2.0,
                 max_overhead: float = 0.02):
        self.directory = directory
        self.key = key
        self.path = os.path.join(directory, f"sweep-{_sanitize(key)}.npz")
        self.every_chunks = max(1, int(every_chunks))
        self.every_s = float(every_s)
        self.max_overhead = float(max_overhead)
        self._n_saves = 0
        self._last_save_dt = 0.0
        self._last_save_chunks = 0
        self._last_save_t = time.perf_counter()

    # -- write ---------------------------------------------------------
    def save(self, state: dict, meta: dict) -> None:
        """Atomically persist ``state`` (numpy arrays / scalars) guarded
        by ``meta`` (JSON-serializable dict, matched exactly on load)."""
        t0 = time.perf_counter()
        os.makedirs(self.directory, exist_ok=True)
        blob = {k: np.asarray(v) for k, v in state.items()
                if v is not None}
        blob[_META_KEY] = np.frombuffer(
            json.dumps(meta, sort_keys=True).encode(), dtype=np.uint8)
        tmp = self.path + f".tmp-{os.getpid()}.npz"
        with open(tmp, "wb") as f:
            np.savez(f, **blob)
        os.replace(tmp, self.path)           # atomic commit
        dt = time.perf_counter() - t0
        self._n_saves += 1
        self._last_save_dt = dt
        m = obs.metrics()
        m.inc("resilience.checkpoint_saves")
        m.inc("resilience.checkpoint_save_s", dt)
        obs.instant("checkpoint-save", key=self.key,
                    bytes=os.path.getsize(self.path), s=round(dt, 5))
        # fault point AFTER the commit so truncate@checkpoint:k corrupts
        # the file a later load must survive
        fault_point("checkpoint", path=self.path)

    def maybe_save(self, state_fn, meta: dict, *, chunks_done: int) -> bool:
        """Save when the cadence (every N chunks or T seconds) is due;
        ``state_fn`` is called lazily only when actually saving.

        The first completed chunk ALWAYS commits — a kill after chunk 0
        must be resumable — and later commits are additionally
        cost-gated: a save only fires once enough sweep wall has passed
        that time-spent-saving stays under ``max_overhead`` of the run,
        so sub-millisecond chunks can't turn an every-chunk cadence into
        double-digit checkpoint overhead."""
        if chunks_done == self._last_save_chunks:
            return False
        if self._n_saves:
            gap = time.perf_counter() - self._last_save_t
            due = (chunks_done - self._last_save_chunks
                   >= self.every_chunks or gap >= self.every_s)
            if not due or gap < self._last_save_dt / self.max_overhead:
                return False
        self.save(state_fn(), meta)
        self._last_save_chunks = chunks_done
        self._last_save_t = time.perf_counter()
        return True

    # -- read ----------------------------------------------------------
    def load(self, meta: dict) -> dict | None:
        """The persisted state, or None (missing / corrupt / stale).
        Corrupt files are quarantined; a successful load bumps
        ``resilience.checkpoint_resumes``."""
        if not os.path.exists(self.path):
            return None
        m = obs.metrics()
        try:
            with np.load(self.path, allow_pickle=False) as z:
                blob = {k: z[k] for k in z.files}
            saved = json.loads(bytes(blob.pop(_META_KEY)).decode())
        except (OSError, ValueError, KeyError, EOFError,
                zipfile.BadZipFile, json.JSONDecodeError) as e:
            self._quarantine(e)
            return None
        if saved != json.loads(json.dumps(meta, sort_keys=True)):
            # different run parameters — chunk boundaries would not line
            # up; discard rather than resume wrongly
            m.inc("resilience.checkpoint_stale")
            self.clear()
            return None
        m.inc("resilience.checkpoint_resumes")
        obs.instant("checkpoint-resume", key=self.key,
                    cursor=int(blob.get("cursor", -1)))
        return blob

    def _quarantine(self, exc: Exception) -> None:
        from .errors import CacheError
        err = CacheError(f"corrupt sweep checkpoint {self.path}: "
                         f"{type(exc).__name__}: {exc}", path=self.path)
        LOG.warning("%s — quarantined, restarting sweep from chunk 0",
                    err.one_line())
        obs.metrics().inc("resilience.checkpoint_corrupt")
        try:
            os.replace(self.path, self.path + ".corrupt")
        except OSError:
            pass

    def clear(self) -> None:
        """Remove the checkpoint (called after a sweep completes)."""
        try:
            os.remove(self.path)
        except OSError:
            pass


# -- top-k entry (value, global row, feature row) packing ---------------

def pack_top(entries: list[tuple]) -> dict:
    """Pack evaluate_genes-style top entries into checkpointable arrays
    (float64 values and int64 rows round-trip bit-exactly)."""
    if not entries:
        return {"top_v": np.zeros(0, np.float64),
                "top_r": np.zeros(0, np.int64),
                "top_f": np.zeros((0, 0), np.float32)}
    return {"top_v": np.array([e[0] for e in entries], np.float64),
            "top_r": np.array([e[1] for e in entries], np.int64),
            "top_f": np.stack([np.asarray(e[2], np.float32)
                               for e in entries])}


def unpack_top(st: dict) -> list[tuple]:
    return [(float(v), int(r), f) for v, r, f in
            zip(st["top_v"], st["top_r"], st["top_f"])]
