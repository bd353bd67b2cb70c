"""On-disk result cache for mapping searches.

A *result* cache keyed by ``(layer, space, hardware, objective, budget,
strategy, seed)`` so a repeated query — same layer swept again in a bigger
co-DSE, a re-run CLI invocation, a notebook re-execution — returns
instantly instead of paying the evaluation cost.  Values are small JSON
payloads (the winning gene tuples and their feature rows), not feature
matrices, so the cache stays tiny and diff-friendly.

The reference's second layer, ``enable_compilation_cache`` (JAX's
persistent compilation cache), has no PyTorch analogue — the port
compiles no executables — and is left out.
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
import threading
from typing import Any

from .. import obs
from ..core.tensor_analysis import LayerOp
from ..resilience.errors import CacheError
from .space import MapSpace

LOG = logging.getLogger("repro_torch.resilience")

# Result-cache payload version, the reference's: the key carries the
# engine schema version and (via ``extra``) the query fingerprint.
CACHE_VERSION = 3

# Version of the engine/query schema behind the declarative front door,
# the reference's.  Bump when query semantics, the report schema, or
# engine numerics change incompatibly.
ENGINE_SCHEMA_VERSION = 2

# Guards the ``result_cache.entries``/``result_cache.bytes`` gauges AND
# the directory transitions they account (store's os.replace, load's
# quarantine rename), so a scan interleaving with a concurrent writer's
# replace can never publish counts that no directory state ever had.
_GAUGE_LOCK = threading.Lock()


def _account(d_entries: int, d_bytes: int) -> None:
    """Adjust the occupancy gauges; caller holds ``_GAUGE_LOCK``."""
    m = obs.metrics()
    m.gauge("result_cache.entries",
            max(0, int(m.gauge_value("result_cache.entries")) + d_entries))
    m.gauge("result_cache.bytes",
            max(0, int(m.gauge_value("result_cache.bytes")) + d_bytes))


def cache_stats(cache_dir: str | None) -> tuple[int, int]:
    """(entries, bytes) of the result cache, measured from the directory
    and published to the gauges — scan and publish under the same lock
    the writers' transitions take, so the gauges always equal a real
    directory state.  The full rescan also reconciles writes from OTHER
    processes sharing the cache dir, which incremental accounting cannot
    see."""
    entries = size = 0
    with _GAUGE_LOCK:
        if cache_dir:
            try:
                with os.scandir(cache_dir) as it:
                    for de in it:
                        if de.name.startswith("mapsearch-") \
                                and de.name.endswith(".json"):
                            entries += 1
                            try:
                                size += de.stat().st_size
                            except OSError:
                                pass
            except OSError:
                pass
        m = obs.metrics()
        m.gauge("result_cache.entries", entries)
        m.gauge("result_cache.bytes", size)
    return entries, size


def op_fingerprint(op: LayerOp) -> str:
    txt = f"{op.name}|{op.op_type}|{sorted(op.dims.items())}"
    return hashlib.sha256(txt.encode()).hexdigest()[:16]


def search_key(op: LayerOp, space: MapSpace, num_pes: int, noc_bw: float,
               objective: str, budget: int, strategy: str, seed: int,
               extra: str = "") -> str:
    txt = "|".join([
        f"v{CACHE_VERSION}", f"schema{ENGINE_SCHEMA_VERSION}",
        op_fingerprint(op), space.fingerprint(),
        f"pes={num_pes}", f"bw={noc_bw}", objective, f"budget={budget}",
        strategy, f"seed={seed}", extra])
    return hashlib.sha256(txt.encode()).hexdigest()[:24]


def _path(cache_dir: str, key: str) -> str:
    return os.path.join(cache_dir, f"mapsearch-{key}.json")


def load(cache_dir: str | None, key: str) -> dict[str, Any] | None:
    """Result-cache lookup.  A corrupt entry (truncated write, bad JSON,
    non-dict payload) is NEVER fatal: it counts as a miss, the file is
    quarantined to ``<entry>.corrupt`` so the recompute can re-store,
    and the event is logged as a one-line :class:`CacheError` warning +
    ``result_cache.corrupt`` counter."""
    if not cache_dir:
        return None
    path = _path(cache_dir, key)
    try:
        with open(path) as f:
            payload = json.load(f)
        if not isinstance(payload, dict):
            raise ValueError(f"expected a JSON object, "
                             f"got {type(payload).__name__}")
    except FileNotFoundError:
        obs.metrics().inc("result_cache.misses")
        return None
    except (OSError, ValueError) as e:
        obs.metrics().inc("result_cache.misses")
        obs.metrics().inc("result_cache.corrupt")
        err = CacheError(f"corrupt result-cache entry {path}: "
                         f"{type(e).__name__}: {e}", key=key)
        LOG.warning("%s — quarantined, treating as a miss",
                    err.one_line())
        # quarantine + gauge adjustment are ONE transition under the
        # gauge lock, so a concurrent cache_stats() scan can never
        # publish counts that still include the quarantined entry
        with _GAUGE_LOCK:
            try:
                gone = os.path.getsize(path)
                os.replace(path, path + ".corrupt")
            except OSError:
                pass               # e.g. unreadable due to permissions
            else:
                _account(-1, -gone)
        return None
    if payload.get("version") != CACHE_VERSION:
        obs.metrics().inc("result_cache.misses")
        return None
    obs.metrics().inc("result_cache.hits")
    return payload


def store(cache_dir: str | None, key: str, payload: dict[str, Any]) -> None:
    if not cache_dir:
        return
    obs.metrics().inc("result_cache.stores")
    os.makedirs(cache_dir, exist_ok=True)
    payload = dict(payload, version=CACHE_VERSION)
    # unique temp name per writer (matches sweepckpt's commit protocol):
    # concurrent server workers sharing a cache dir each write their own
    # temp file, so no interleaved writes can produce a torn entry — the
    # last os.replace wins whole
    tmp = (_path(cache_dir, key)
           + f".tmp-{os.getpid()}-{threading.get_ident()}")
    with open(tmp, "w") as f:
        json.dump(payload, f)
    # the commit (os.replace) and its gauge delta happen under one lock:
    # the occupancy gauges track every directory transition instead of
    # waiting for the next metrics() scan, and concurrent writers can
    # never interleave a scan between replace and publish
    dst = _path(cache_dir, key)
    with _GAUGE_LOCK:
        try:
            old = os.path.getsize(dst)
            fresh = 0
        except OSError:
            old, fresh = 0, 1
        new = os.path.getsize(tmp)
        os.replace(tmp, dst)
        _account(fresh, new - old)
