"""Universal batched evaluation: the whole mapping space through ONE
evaluator per (op, level-count).

``repro_torch.mapspace.batched`` groups candidates by (spatial × perm ×
cluster) structure and runs one tile evaluator per group.  This module
encodes the *entire* gene tuple as operand columns of
``core.vectorized.universal_evaluator`` instead:

  * tile sizes / offsets — as before;
  * the permutation — a rank vector (axis -> position in the loop order);
  * the spatial choice — a one-hot selector;
  * the cluster option — a cluster size column + a one-hot over the
    space's (inner dim, inner map) candidates;
  * the hardware point (#PEs, NoC bandwidth) — a column per row, so the
    co-DSE's mapping × hardware frontier needs no new evaluator either.

The port compiles nothing: where the reference pays one XLA compile per
(spec, block) executable, the port's first pass at a (spec, block) shape
is its warm-up pass (allocator growth, first-use kernel loading) and is
counted in the same fields — ``n_compiles`` counts first passes,
``compile_s`` their seconds — so the reference's accounting carries over.
Chunks stripe over ``n_devices`` CUDA devices (default: all) and the
host merges the per-device results by (value, global index), so results
are identical at any device count.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
import time
from typing import Sequence

import numpy as np
import torch

from .. import obs
from ..devices import resolve_device
from ..resilience import (CHUNK_WATCHDOG, RetryPolicy, SweepCheckpoint,
                          SweepKilled, array_hash, check_cancel,
                          default_policy, fault_point, is_oom, pack_top,
                          run_attempts, unpack_top)
from ..core.tensor_analysis import LayerOp
from ..core.vectorized import (FEATURES, HWTail, ReduceSpec, UniversalSpec,
                               universal_evaluator,
                               universal_reduced_evaluator)
from .space import (ClusterOption, MapSpace, Point, _resolve_sz,
                    gene_tables)

# Evaluators warmed at a given block shape this process (same role as
# ``batched._WARMED``).  The matching count lives in the obs metrics
# registry (``universal.compiles``): warm_once() is the single writer of
# both, so the process counter, the per-family counters, and every
# run-local ``n_compiles`` (which increments iff warm_once returned True)
# can never drift apart.
_WARMED: set[tuple] = set()
_WARM_LOCK = threading.Lock()


def compile_count() -> int:
    """Process-wide number of first (warm-up) universal passes.  Reads the
    obs metrics counter that :func:`warm_once` maintains."""
    return int(obs.metrics().value("universal.compiles"))


def is_warm(key: tuple) -> bool:
    """Whether a first (warm-up) pass was already recorded under ``key``."""
    return key in _WARMED


def warm_once(key: tuple, *, family: str | None = None,
              seconds: float = 0.0) -> bool:
    """Record a first (warm-up) universal pass under an arbitrary hashable
    key; returns True when the key was new.  Call AFTER the first pass
    completes (gate on :func:`is_warm`) so a failed pass is retried and
    counted, not silently treated as warm.

    THE single writer of the warm-up metrics: bumps ``universal.compiles``
    plus the per-``family`` counter (label e.g. ``conv1:L2``) and
    ``universal.compile_s``.  Callers increment their run-local
    ``n_compiles`` iff this returns True, so run stats and the process
    counter agree by construction (asserted here)."""
    m = obs.metrics()
    with _WARM_LOCK:
        if key in _WARMED:
            return False
        _WARMED.add(key)
        n = m.inc("universal.compiles")
        m.inc("universal.compiles_by_family", family=family or "other")
        if seconds:
            m.inc("universal.compile_s", seconds)
        # parity: the counter counts exactly the warmed keys
        assert int(n) == len(_WARMED), \
            f"compile counter drift: {int(n)} != {len(_WARMED)} warmed keys"
    return True


def mark_warmed(op: LayerOp, spec, multicast: bool, reduction: bool,
                n_rows: int, device: torch.device) -> bool:
    """Record a first universal pass at an ad-hoc batch shape — e.g.
    ``measure_rate``'s timing batches, which bypass
    :func:`evaluate_encoded`.  Returns True when the shape was new."""
    return warm_once(_warm_key(op, spec, multicast, reduction, n_rows,
                               device), family=family_label(op, spec))


def family_label(op: LayerOp, spec) -> str:
    """Human-readable (op, level-count) family name for metrics/spans:
    ``conv1:L2`` = conv1's 2-level (clustered) evaluator family."""
    return f"{op.name}:L{2 if getattr(spec, 'cluster', None) else 1}"


def _cluster_candidate(copt: ClusterOption, op: LayerOp
                       ) -> tuple[str, int, int]:
    """Resolved (inner_dim, inner_size, inner_offset) of a cluster option —
    the static inner-map identity the csel one-hot selects over (the
    cluster *size* stays an operand)."""
    ext = op.dims[copt.inner_dim]
    return (copt.inner_dim,
            min(_resolve_sz(copt.inner_size, op), ext),
            min(_resolve_sz(copt.inner_offset, op), ext))


def universal_specs(op: LayerOp, space: MapSpace
                    ) -> tuple[UniversalSpec, UniversalSpec | None]:
    """The (1-level, 2-level) evaluator specs for a space; the 2-level
    spec is ``None`` when the space has no Cluster options."""
    dim_names = tuple(op.dims)
    axis_dims = tuple(ax.dim for ax in space.axes)
    for d in axis_dims:
        if d not in op.dims:
            raise ValueError(f"axis dim {d!r} not an op dim")
    cands: list[tuple[str, int, int]] = []
    for copt in space.cluster_options:
        if copt is None:
            continue
        cand = _cluster_candidate(copt, op)
        if cand not in cands:
            cands.append(cand)
    # MapSpace tiles are divisor-legal by construction: temporal axes never
    # produce an edge phase, so the A+1 single-edge enumeration is exact
    spec1 = UniversalSpec(dim_names=dim_names, axis_dims=axis_dims,
                          pinned=tuple(space.pinned), single_edge=True)
    spec2 = UniversalSpec(dim_names=dim_names, axis_dims=axis_dims,
                          pinned=tuple(space.pinned), cluster=tuple(cands),
                          single_edge=True) if cands else None
    return spec1, spec2


def _candidate_index(space: MapSpace, op: LayerOp,
                     cands: tuple[tuple[str, int, int], ...]
                     ) -> dict[int, tuple[int, int]]:
    """cluster_idx -> (candidate index, cluster size) for non-None options."""
    out: dict[int, tuple[int, int]] = {}
    for ci, copt in enumerate(space.cluster_options):
        if copt is None:
            continue
        out[ci] = (cands.index(_cluster_candidate(copt, op)),
                   int(copt.size))
    return out


def encode_points(op: LayerOp, space: MapSpace, points: Sequence[Point],
                  spec: UniversalSpec, *, num_pes, noc_bw
                  ) -> dict[str, np.ndarray]:
    """Operand arrays for points of ONE level-count family.

    ``num_pes``/``noc_bw`` may be scalars (fixed hardware) or per-point
    arrays (joint mapping × hardware rows)."""
    n, a = len(points), len(space.axes)
    ops = {
        "sizes": np.empty((n, a), np.float32),
        "offsets": np.empty((n, a), np.float32),
        "rank": np.empty((n, a), np.float32),
        "sp": np.zeros((n, a), np.float32),
        "pes": np.broadcast_to(
            np.asarray(num_pes, np.float32), (n,)).copy(),
        "bw": np.broadcast_to(
            np.asarray(noc_bw, np.float32), (n,)).copy(),
    }
    if spec.cluster:
        ops["csize"] = np.empty((n,), np.float32)
        ops["csel"] = np.zeros((n, len(spec.cluster)), np.float32)
        cidx = _candidate_index(space, op, spec.cluster)
    for i, pt in enumerate(points):
        s_i, p_i, c_i = pt[:3]
        tiles = pt[3:]
        for ai, ax in enumerate(space.axes):
            ops["sizes"][i, ai] = ax.sizes[tiles[ai]]
            ops["offsets"][i, ai] = ax.offsets[tiles[ai]]
        for pos, ai in enumerate(space.perms[p_i]):
            ops["rank"][i, ai] = pos
        ops["sp"][i, space.spatial_choices[s_i]] = 1.0
        if spec.cluster:
            if c_i not in cidx:
                raise ValueError(f"point {pt} is not a 2-level mapping")
            k, csize = cidx[c_i]
            ops["csel"][i, k] = 1.0
            ops["csize"][i] = csize
        elif space.cluster_options[c_i] is not None:
            raise ValueError(f"point {pt} is not a 1-level mapping")
    return ops


@dataclasses.dataclass
class UniversalRun:
    """Timing bookkeeping of one universal evaluation pass."""
    n_rows: int = 0
    n_compiles: int = 0
    compile_s: float = 0.0
    eval_s: float = 0.0


def _warm_key(op: LayerOp, spec: UniversalSpec, multicast, reduction,
              block: int, device: torch.device) -> tuple:
    return (op.name, tuple(sorted(op.dims.items())), op.op_type, spec,
            bool(multicast), bool(reduction), block, device.type)


def _on(dev: torch.device):
    """Make ``dev`` current while work is issued to it (its current
    stream takes the kernels)."""
    return torch.cuda.device(dev) if dev.type == "cuda" \
        else contextlib.nullcontext()


def _sync(devs: Sequence[torch.device]) -> None:
    for d in devs:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _devices(device, n_devices: int | None) -> list[torch.device]:
    """The devices a pass stripes over: ``n_devices`` CUDA devices
    (default all, capped at what exists) starting at ``device``'s index;
    one device otherwise."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return [dev]
    avail = torch.cuda.device_count()
    nd = avail if n_devices is None else n_devices
    nd = max(1, min(nd, avail))
    base = dev.index or 0
    return [torch.device("cuda", (base + i) % avail) for i in range(nd)]


def _to_device(batch: dict[str, np.ndarray], dev: torch.device
               ) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in batch.items()}


def evaluate_encoded(op: LayerOp, spec: UniversalSpec,
                     ops: dict[str, np.ndarray], *, block: int = 1024,
                     multicast: bool = True, spatial_reduction: bool = True,
                     device: str | torch.device | None = None
                     ) -> tuple[np.ndarray, UniversalRun]:
    """Run one operand batch through the universal evaluator with fixed
    block padding (as the reference pads to one executable shape); returns
    ``(features[n, F], run_stats)``."""
    dev = resolve_device(device)
    f = universal_evaluator(op, spec, multicast=multicast,
                            spatial_reduction=spatial_reduction)
    n = len(ops["pes"])
    feats = np.empty((n, len(FEATURES)), np.float32)
    run = UniversalRun(n_rows=n)
    wk = _warm_key(op, spec, multicast, spatial_reduction, block, dev)
    for lo in range(0, n, block):
        hi = min(lo + block, n)
        pad = block - (hi - lo)
        batch = {}
        for k, v in ops.items():
            chunk = v[lo:hi]
            if pad:
                chunk = np.concatenate(
                    [chunk, np.repeat(v[lo:lo + 1], pad, 0)])
            batch[k] = chunk
        batch = _to_device(batch, dev)
        fam = family_label(op, spec)
        with _on(dev):
            if not is_warm(wk):
                # first pass at this shape: the warm-up — re-run timed so
                # every batch contributes a steady-rate sample
                with obs.span("compile", family=fam, rows=block):
                    t0 = time.perf_counter()
                    f(batch).cpu()
                    dt = time.perf_counter() - t0
                if warm_once(wk, family=fam, seconds=dt):
                    run.compile_s += dt
                    run.n_compiles += 1
            else:
                obs.metrics().inc("universal.warm_hits", family=fam)
            with obs.span("device-pass", family=fam, rows=hi - lo):
                t0 = time.perf_counter()
                out = f(batch).cpu().numpy()
                run.eval_s += time.perf_counter() - t0
        feats[lo:hi] = out[:hi - lo]
    return feats, run


# ----------------------------------------------------------------------
# Gene pipeline: vectorized encode + double-buffered striped evaluation
# ----------------------------------------------------------------------

def encode_genes_base(op: LayerOp, space: MapSpace, genes: np.ndarray, *,
                      num_pes, noc_bw) -> dict[str, np.ndarray]:
    """The cluster-agnostic part of :func:`encode_genes` — tile sizes/
    offsets, permutation ranks, spatial one-hot and the hardware point."""
    tb = gene_tables(op, space)
    genes = np.asarray(genes, np.int64)
    n, a = genes.shape[0], len(space.axes)
    tiles = genes[:, 3:]
    ar = np.arange(a)[None, :]
    sp = np.zeros((n, a), np.float32)
    sp[np.arange(n), tb.spatial_axis[genes[:, 0]]] = 1.0
    return {
        "sizes": tb.size_tab[ar, tiles],
        "offsets": tb.off_tab[ar, tiles],
        "rank": tb.perm_rank[genes[:, 1]],
        "sp": sp,
        "pes": np.broadcast_to(
            np.asarray(num_pes, np.float32), (n,)).copy(),
        "bw": np.broadcast_to(
            np.asarray(noc_bw, np.float32), (n,)).copy(),
    }


def encode_genes(op: LayerOp, space: MapSpace, genes: np.ndarray,
                 spec: UniversalSpec, *, num_pes, noc_bw
                 ) -> dict[str, np.ndarray]:
    """Vectorized :func:`encode_points` over an (n, G) gene matrix: all
    operand arrays are built by numpy gathers over the space's lookup
    tables (``space.gene_tables``) and one-hot scatters — no Python
    per-point loop.  Produces byte-identical operands to the per-point
    encoder (the parity-oracle path)."""
    tb = gene_tables(op, space)
    genes = np.asarray(genes, np.int64)
    n = genes.shape[0]
    ops = encode_genes_base(op, space, genes, num_pes=num_pes,
                            noc_bw=noc_bw)
    is_none = tb.cluster_is_none[genes[:, 2]]
    if spec.cluster:
        if is_none.any():
            raise ValueError("1-level rows passed to a 2-level spec")
        cidx = _candidate_index(space, op, spec.cluster)
        cand_of = np.full(len(space.cluster_options), -1, np.int64)
        for ci, (kk, _) in cidx.items():
            cand_of[ci] = kk
        csel = np.zeros((n, len(spec.cluster)), np.float32)
        csel[np.arange(n), cand_of[genes[:, 2]]] = 1.0
        ops["csel"] = csel
        ops["csize"] = tb.csize_tab[genes[:, 2]]
    elif not is_none.all():
        raise ValueError("2-level rows passed to a 1-level spec")
    return ops


@dataclasses.dataclass
class GeneRun:
    """Timing/size bookkeeping of one gene-pipeline evaluation.

    ``encode_s`` is host time building + transferring operand chunks;
    ``eval_s`` is time the host spent *blocked* on device results (a lower
    bound on device time — encode of chunk i+1 overlaps evaluation of
    chunk i); ``e2e_s`` is the full wall time of the pass.  ``n_compiles``
    and ``compile_s`` count the first (warm-up) pass of each (spec, block)
    shape, which the port runs where the reference compiles; ``n_steady``
    counts the rows of the other passes."""
    n_rows: int = 0
    n_valid: int = 0
    n_steady: int = 0        # rows dispatched in steady (non-warm-up) chunks
    n_compiles: int = 0
    compile_s: float = 0.0
    eval_s: float = 0.0
    encode_s: float = 0.0
    e2e_s: float = 0.0
    n_devices: int = 1

    def merge(self, other: "GeneRun") -> None:
        self.n_rows += other.n_rows
        self.n_valid += other.n_valid
        self.n_steady += other.n_steady
        self.n_compiles += other.n_compiles
        self.compile_s += other.compile_s
        self.eval_s += other.eval_s
        self.encode_s += other.encode_s
        self.e2e_s += other.e2e_s
        self.n_devices = max(self.n_devices, other.n_devices)


@dataclasses.dataclass
class GeneEval:
    """Result of one evaluation pass over a gene matrix.

    ``top`` rows are global indices into the input gene matrix; ``values``
    are canonical-minimize objective values (negate for maximize
    objectives).  ``pareto`` is the exact (energy min, throughput max)
    frontier over all evaluated rows, host-refined from the per-chunk
    device candidate masks."""
    top: list[dict]                    # [{row, value, feats}]
    pareto: list[dict]                 # [{row, energy_pj, throughput}]
    run: GeneRun
    vals: np.ndarray | None = None     # (n,) objective column (optional)


def _pad_rows(v: np.ndarray, pad: int) -> np.ndarray:
    if not pad:
        return v
    return np.concatenate([v, np.repeat(v[-1:], pad, axis=0)])


def pareto_front(entries: Sequence[dict], x: str = "energy_pj",
                 y: str = "throughput") -> list[dict]:
    """Exact (min ``x``, max ``y``) frontier over candidate dicts — THE
    host-side refinement shared by the gene pipeline and the co-DSE
    (sorted() is stable, so ties keep the callers' row order)."""
    order = sorted(range(len(entries)),
                   key=lambda i: (entries[i][x], -entries[i][y]))
    front, best = [], -np.inf
    for i in order:
        if entries[i][y] > best and np.isfinite(entries[i][x]):
            best = entries[i][y]
            front.append(entries[i])
    return front


def evaluate_genes(op: LayerOp, space: MapSpace, genes: np.ndarray, *,
                   objective: str = "edp", maximize: bool = False,
                   k: int = 8, num_pes, noc_bw, block: int = 1024,
                   n_devices: int | None = None, depth: int = 2,
                   multicast: bool = True, spatial_reduction: bool = True,
                   return_vals: bool = True, pareto: bool = True,
                   hw_tail: HWTail | None = None,
                   ckpt: SweepCheckpoint | None = None,
                   retry: RetryPolicy | None = None,
                   device: str | torch.device | None = None,
                   _splits_left: int | None = None) -> GeneEval:
    """Evaluation of a gene matrix on ``device`` (``cuda`` unless the
    caller asks for another): vectorized encode, double-buffered dispatch
    (chunk i+1 encodes on the host while chunk i evaluates), chunks
    striped over ``n_devices`` CUDA devices (default: all; one on the
    CPU), and the objective/top-k/Pareto reduction run on the device —
    each chunk returns k winner rows plus a small frontier slice instead of
    the (n, F) feature matrix.

    ``objective`` is a FEATURES column name; ``num_pes``/``noc_bw`` may be
    scalars or per-row arrays (joint mapping x hardware rows); ``hw_tail``
    folds run_dse-style area/power/leakage accounting into the reduction.
    Results are deterministic and identical for any device count.

    Resilience: every chunk runs under ``retry`` (default: the installed
    ``resilience.default_policy()``) — a failed device pass re-encodes and
    re-dispatches with backoff on the same device; device OOM recursively
    re-evaluates just the failed chunk at half the block size on one
    device (``resilience.chunk_splits``); budget exhaustion surfaces a
    ``DeviceError``.  No failure moves the work to another device type.
    With ``ckpt`` (a ``resilience.SweepCheckpoint``) the running
    accumulators are persisted every few chunks, and a killed sweep
    resumes from the last saved chunk boundary with bit-identical final
    results: merges are order-insensitive (top-k sorts on (value, row);
    the Pareto refinement argsorts candidates by row) and the chunk layout
    is pinned by the checkpoint's meta guard (row count, block, device
    count, content hash)."""
    t_start = time.perf_counter()
    devs = _devices(device, n_devices)
    nd = len(devs)
    genes = np.asarray(genes, np.int64)
    n = genes.shape[0]
    retry = retry or default_policy()
    splits_left = retry.max_splits if _splits_left is None else _splits_left
    spec1, spec2 = universal_specs(op, space)
    pes = np.broadcast_to(np.asarray(num_pes, np.float32), (n,))
    bw = np.broadcast_to(np.asarray(noc_bw, np.float32), (n,))
    is2 = ~gene_tables(op, space).cluster_is_none[genes[:, 2]]

    run = GeneRun(n_rows=n, n_devices=nd)
    vals = np.empty(n, np.float64) if return_vals else None
    top_entries: list[tuple[float, int, np.ndarray]] = []
    cand_rows: list[np.ndarray] = []
    cand_e: list[np.ndarray] = []
    cand_t: list[np.ndarray] = []

    def collect(sub: np.ndarray, m: int, out) -> None:
        shards, events = out
        met = obs.metrics()
        # the blocked wait for (and host copy of) this chunk's reduced
        # device results — the host-visible tail of the device pass
        with obs.span("device-pass", op=op.name, rows=m, devices=nd):
            t0 = time.perf_counter()
            for ev in events:
                ev.synchronize()
            host = {kk: np.stack([s[kk].cpu().numpy() for s in shards])
                    for kk in shards[0]}
            dt = time.perf_counter() - t0
        run.eval_s += dt
        met.observe("gene.collect_wait_s", dt)
        met.inc("gene.merge_bytes", sum(v.nbytes for v in host.values()))
        chunk_rows = nd * block
        with obs.span("topk-merge", op=op.name, rows=m):
            if return_vals:
                vals[sub] = host["vals"].reshape(chunk_rows)[:m]
            tv = host["top_vals"].reshape(-1)
            ti = host["top_idx"].reshape(-1).astype(np.int64)
            tf = host["top_feats"].reshape(-1, len(FEATURES))
            # local shard index -> chunk row
            kk = host["top_vals"].shape[-1]
            ti = ti + np.repeat(np.arange(nd) * block, kk)
            # padding rows can never reach the top (live=0 forces obj=inf
            # AND idx >= m); real rows with an inf objective are kept,
            # mirroring the legacy host reduction which sorts them last
            # rather than dropping them
            keep = ti < m
            for v, i, row in zip(tv[keep], ti[keep], tf[keep]):
                top_entries.append((float(v), int(sub[i]), row))
            run.n_valid += int(np.sum(host["n_valid"]))
            if pareto:
                mask = host["pareto_mask"].reshape(chunk_rows)[:m]
                w = np.where(mask)[0]
                cand_rows.append(sub[w])
                cand_e.append(
                    host["pareto_energy"].reshape(chunk_rows)[:m][w])
                cand_t.append(
                    host["pareto_thr"].reshape(chunk_rows)[:m][w])

    def safe_collect(sub: np.ndarray, m: int, out) -> None:
        # transactional merge: roll back partial accumulator appends on
        # failure so a retried collect never duplicates top/Pareto rows
        marks = (len(top_entries), len(cand_rows), run.n_valid)
        try:
            collect(sub, m, out)
        except Exception:
            del top_entries[marks[0]:]
            del cand_rows[marks[1]:]
            del cand_e[marks[1]:]
            del cand_t[marks[1]:]
            run.n_valid = marks[2]
            raise

    met = obs.metrics()
    met.inc("gene.rows_evaluated", n)
    n_compiles_at_entry = run.n_compiles
    c0 = compile_count()

    # -- resilience state: resume cursor + periodic checkpoint ----------
    start_cursor = 0           # chunks already merged by a prior run
    chunks_done = 0            # chunks merged so far, in dispatch order
    gidx = 0                   # global dispatch index across families
    ckpt_meta: dict | None = None
    if ckpt is not None:
        ckpt_meta = {"key": ckpt.key, "n": int(n), "block": int(block),
                     "nd": int(nd), "objective": objective,
                     "maximize": bool(maximize), "k": int(k),
                     "pareto": bool(pareto),
                     "return_vals": bool(return_vals),
                     "content": array_hash(genes, pes, bw)}
        st = ckpt.load(ckpt_meta)
        if st is not None:
            start_cursor = chunks_done = int(st["cursor"])
            run.n_valid = int(st["n_valid"])
            top_entries.extend(unpack_top(st))
            if return_vals and "vals" in st:
                vals[:] = st["vals"]
            if pareto and st["cand_rows"].size:
                cand_rows.append(st["cand_rows"].astype(np.int64))
                cand_e.append(st["cand_e"])
                cand_t.append(st["cand_t"])

    def ckpt_state() -> dict:
        state = {"cursor": chunks_done, "n_valid": run.n_valid,
                 **pack_top(top_entries)}
        if return_vals:
            state["vals"] = vals
        if pareto:
            state["cand_rows"] = (np.concatenate(cand_rows)
                                  if cand_rows else np.zeros(0, np.int64))
            state["cand_e"] = (np.concatenate(cand_e)
                              if cand_e else np.zeros(0, np.float32))
            state["cand_t"] = (np.concatenate(cand_t)
                              if cand_t else np.zeros(0, np.float32))
        return state

    def split_eval(sub: np.ndarray) -> None:
        # OOM recovery: the same rows at half the block on one device —
        # an independent exact evaluation whose merge is bit-transparent
        # (a row dominated within any sub-chunk can never reach the
        # global frontier, and the top-k merge sorts on (value, row))
        rec = evaluate_genes(
            op, space, genes[sub], objective=objective, maximize=maximize,
            k=k, num_pes=pes[sub], noc_bw=bw[sub],
            block=max(retry.min_rows, block // 2), n_devices=1,
            depth=depth, multicast=multicast,
            spatial_reduction=spatial_reduction, return_vals=return_vals,
            pareto=pareto, hw_tail=hw_tail, retry=retry, device=devs[0],
            _splits_left=splits_left - 1)
        if return_vals:
            vals[sub] = rec.vals
        for t in rec.top:
            top_entries.append((float(t["value"]), int(sub[t["row"]]),
                                t["feats"]))
        if pareto and rec.pareto:
            rws = np.array([p["row"] for p in rec.pareto], np.int64)
            cand_rows.append(sub[rws])
            cand_e.append(np.array([p["energy_pj"] for p in rec.pareto],
                                   np.float64))
            cand_t.append(np.array([p["throughput"] for p in rec.pareto],
                                   np.float64))
        run.n_valid += rec.run.n_valid
        run.n_steady += rec.run.n_steady
        run.n_compiles += rec.run.n_compiles
        run.compile_s += rec.run.compile_s
        run.eval_s += rec.run.eval_s
        run.encode_s += rec.run.encode_s

    for spec, fam in ((spec1, np.where(~is2)[0]),
                      (spec2, np.where(is2)[0])):
        if fam.size == 0:
            continue
        assert spec is not None
        fam_label = family_label(op, spec)
        chunk_rows = nd * block
        reduce = ReduceSpec(objective=objective, maximize=maximize,
                            k=min(k, chunk_rows), return_vals=return_vals,
                            pareto=pareto, hw=hw_tail)
        f = universal_reduced_evaluator(
            op, spec, reduce, multicast=multicast,
            spatial_reduction=spatial_reduction)
        wk = (_warm_key(op, spec, multicast, spatial_reduction,
                        chunk_rows, devs[0]), reduce, nd)
        pending: collections.deque = collections.deque()

        def make_chunk(sub, m, in_flight):
            with obs.span("encode", family=fam_label, rows=m):
                t0 = time.perf_counter()
                batch = encode_genes(op, space, genes[sub], spec,
                                     num_pes=pes[sub], noc_bw=bw[sub])
                pad = chunk_rows - m
                live = np.zeros(chunk_rows, np.float32)
                live[:m] = 1.0
                batch = {kk: _pad_rows(v, pad) for kk, v in batch.items()}
                batch["live"] = live
                shards = [_to_device({kk: v[d * block:(d + 1) * block]
                                      for kk, v in batch.items()}, dev)
                          for d, dev in enumerate(devs)]
                t_enc = time.perf_counter() - t0
                run.encode_s += t_enc
            if in_flight:
                # double-buffer overlap, measured not guessed: host
                # encode time spent while >= 1 chunk was in flight
                met.inc("gene.overlap_encode_s", t_enc)
            met.observe("gene.chunk_occupancy", m / chunk_rows)
            return shards

        def launch(shards):
            outs, events = [], []
            for dev, shard in zip(devs, shards):
                with _on(dev):
                    outs.append(f(shard))
                    if dev.type == "cuda":
                        ev = torch.cuda.Event()
                        ev.record()
                        events.append(ev)
            return outs, events

        def dispatch(shards, m):
            check_cancel("chunk")
            fault_point("chunk")
            if not is_warm(wk):
                with obs.span("compile", family=fam_label,
                              rows=chunk_rows, devices=nd):
                    t0 = time.perf_counter()
                    out = launch(shards)
                    _sync(devs)
                    dt = time.perf_counter() - t0
                if warm_once(wk, family=fam_label, seconds=dt):
                    run.compile_s += dt
                    run.n_compiles += 1
            else:
                met.inc("universal.warm_hits", family=fam_label)
                with obs.span("dispatch", family=fam_label, rows=m,
                              devices=nd):
                    t0 = time.perf_counter()
                    out = launch(shards)    # asynchronous on CUDA
                    met.observe("gene.dispatch_s",
                                time.perf_counter() - t0)
                run.n_steady += m
            return out

        def recover(sub, m, exc):
            if isinstance(exc, SweepKilled):
                raise exc            # simulated process death: no retry
            if is_oom(exc) and splits_left > 0 and block > retry.min_rows:
                met.inc("resilience.chunk_splits")
                obs.instant("chunk-split", family=fam_label, rows=int(m),
                            block=block,
                            to=max(retry.min_rows, block // 2))
                split_eval(sub)
                return

            def once():
                safe_collect(sub, m, dispatch(make_chunk(sub, m, False),
                                              m))
            run_attempts(once, policy=retry,
                         label=f"{fam_label} chunk", first_exc=exc)

        def finish(sub, m, out, t_disp):
            nonlocal chunks_done
            try:
                safe_collect(sub, m, out)
            except Exception as exc:  # noqa: BLE001 — recover classifies
                recover(sub, m, exc)
            wall = time.perf_counter() - t_disp
            CHUNK_WATCHDOG.observe(wall, family=fam_label, rows=int(m))
            retry.check_deadline(wall, family=fam_label, rows=int(m))
            chunks_done += 1
            if ckpt is not None:
                ckpt.maybe_save(ckpt_state, ckpt_meta,
                                chunks_done=chunks_done)

        for lo in range(0, fam.size, chunk_rows):
            if gidx < start_cursor:
                gidx += 1        # merged by the resumed checkpoint
                continue
            gidx += 1
            sub = fam[lo:lo + chunk_rows]
            m = sub.size
            try:
                out = dispatch(make_chunk(sub, m, bool(pending)), m)
            except Exception as exc:  # noqa: BLE001 — recover classifies
                # drain in dispatch order first so the chunk cursor stays
                # contiguous, then recover this chunk synchronously
                while pending:
                    finish(*pending.popleft())
                recover(sub, m, exc)
                chunks_done += 1
                if ckpt is not None:
                    ckpt.maybe_save(ckpt_state, ckpt_meta,
                                    chunks_done=chunks_done)
                continue
            pending.append((sub, m, out, time.perf_counter()))
            while len(pending) > depth:
                finish(*pending.popleft())
        while pending:
            finish(*pending.popleft())
    # run-local vs process warm-up accounting cannot drift: both increment
    # on the same warm_once() event (recursive split merges move both)
    assert compile_count() - c0 == run.n_compiles - n_compiles_at_entry
    if ckpt is not None:
        ckpt.clear()               # completed: the checkpoint is spent

    top_entries.sort(key=lambda e: (e[0], e[1]))
    top = [{"row": r, "value": v, "feats": fr}
           for v, r, fr in top_entries[:k]]
    front: list[dict] = []
    if pareto and cand_rows:
        rows = np.concatenate(cand_rows)
        es = np.concatenate(cand_e)
        ts = np.concatenate(cand_t)
        by_row = np.argsort(rows, kind="stable")
        front = pareto_front(
            [{"row": int(rows[i]), "energy_pj": float(es[i]),
              "throughput": float(ts[i])} for i in by_row])
    run.e2e_s = time.perf_counter() - t_start
    # blocked-wait time understates device time under overlap; wall minus
    # host work is the tighter lower bound of the two
    run.eval_s = max(run.eval_s,
                     run.e2e_s - run.encode_s - run.compile_s)
    return GeneEval(top=top, pareto=front, run=run, vals=vals)


def evaluate_points_universal(op: LayerOp, space: MapSpace,
                              points: Sequence[Point], *, num_pes,
                              noc_bw, block: int = 1024,
                              multicast: bool = True,
                              spatial_reduction: bool = True,
                              device: str | torch.device | None = None
                              ) -> tuple[np.ndarray, UniversalRun]:
    """Evaluate arbitrary mapping points — any mix of structure groups —
    through at most TWO evaluators (1-level + 2-level families).

    ``num_pes``/``noc_bw`` may be per-point arrays: the hardware point is
    an operand of the same evaluator (the co-DSE's joint frontier)."""
    spec1, spec2 = universal_specs(op, space)
    pes = np.broadcast_to(np.asarray(num_pes, np.float32),
                          (len(points),))
    bw = np.broadcast_to(np.asarray(noc_bw, np.float32), (len(points),))
    lvl1_idx = [i for i, pt in enumerate(points)
                if space.cluster_options[pt[2]] is None]
    lvl2_idx = [i for i, pt in enumerate(points)
                if space.cluster_options[pt[2]] is not None]
    feats = np.empty((len(points), len(FEATURES)), np.float32)
    run = UniversalRun(n_rows=len(points))
    for spec, idxs in ((spec1, lvl1_idx), (spec2, lvl2_idx)):
        if not idxs:
            continue
        assert spec is not None
        ops = encode_points(op, space, [points[i] for i in idxs], spec,
                            num_pes=pes[idxs], noc_bw=bw[idxs])
        sub, r = evaluate_encoded(op, spec, ops, block=block,
                                  multicast=multicast,
                                  spatial_reduction=spatial_reduction,
                                  device=device)
        feats[idxs] = sub
        run.n_compiles += r.n_compiles
        run.compile_s += r.compile_s
        run.eval_s += r.eval_s
    return feats, run
