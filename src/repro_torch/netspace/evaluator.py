"""Batched multi-layer evaluation: layer shape as an operand — the port of
``repro.netspace.evaluator``.

The universal evaluator already treats tile sizes, loop order, spatial
choice, cluster option and the hardware point as operand columns of one
evaluator.  This module adds the last structural axis — the LAYER SHAPE
— so one evaluator per (op-class, level-count) produces the candidate
frontiers of every layer of a network in a single device pass over a
``(n_layers, n_candidates, G)`` gene tensor:

  * ``ext`` (i, D): the dim extents of row i's layer;
  * ``cin_size``/``cin_off`` (i, K): the layer-resolved cluster inner
    maps (the sliding ``SpatialMap(Sz(S), 1)`` inner differs per layer);
  * everything else encodes exactly like the per-layer gene pipeline
    (``universal.encode_genes_base`` — shared code, not a twin).

The layer shape is float32 on the device, as in the reference, so every
extent-derived quantity runs as float32 tensor math rather than exact
Python ints.  The evaluator closes over the class's representative layer
(``NetClass.rep``): whatever the engine still reads from ``op``
statically comes from that layer for every row of the class, as in the
reference.

Evaluation reuses the reduction tail
(``core.vectorized.universal_reduced_evaluator``) with the per-row
objective column plus the (runtime, energy, L1, L2) columns the network
composer needs.  Chunks stripe over ``n_devices`` CUDA devices (default
all; one on the CPU) with double buffering, each shard copied to its
device once per operand; outputs are per row, so results are identical at
any device count.  The port compiles nothing: ``n_compiles`` counts the
first pass at each (spec, block) shape, as in ``mapspace.universal``.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Sequence

import numpy as np
import torch

from .. import obs
from ..core.vectorized import (HWTail, ReduceSpec,
                               universal_reduced_evaluator)
from ..mapspace.search import OBJECTIVES
from ..mapspace.space import dedupe_equivalent_genes, gene_tables
from ..mapspace.universal import (GeneRun, _devices, _on, _pad_rows, _sync,
                                  _to_device, compile_count,
                                  encode_genes_base, is_warm, warm_once)
from ..resilience import (CHUNK_WATCHDOG, RetryPolicy, SweepCheckpoint,
                          SweepKilled, array_hash, check_cancel,
                          default_policy, fault_point, is_oom,
                          run_attempts)
from .space import NetSpace

# The per-row feature columns the composer consumes.
COLS = ("runtime", "energy_pj", "l1_kb", "l2_kb")


@dataclasses.dataclass
class NetEval:
    """Per-candidate results of one network evaluation pass.

    ``vals[u][i]`` is the canonical-minimize objective of candidate ``i``
    of unique layer ``u``; ``cols[u]`` the matching ``(n, len(COLS))``
    feature columns."""
    vals: list[np.ndarray]
    cols: list[np.ndarray]
    run: GeneRun


def _encode_rows(ns: NetSpace, cls, uid: np.ndarray, genes: np.ndarray,
                 spec, *, pes: np.ndarray, bw: np.ndarray
                 ) -> dict[str, np.ndarray]:
    """Operand arrays for rows of ONE (class, level-count) family; rows
    may mix layers (``uid`` per row)."""
    n = genes.shape[0]
    a = len(cls.dims)
    d = len(spec.dim_names)
    ops = {
        "sizes": np.empty((n, a), np.float32),
        "offsets": np.empty((n, a), np.float32),
        "rank": np.empty((n, a), np.float32),
        "sp": np.zeros((n, a), np.float32),
        "ext": np.empty((n, d), np.float32),
        "pes": np.asarray(pes, np.float32).copy(),
        "bw": np.asarray(bw, np.float32).copy(),
    }
    if spec.cluster:
        k = len(spec.cluster)
        ops["csize"] = np.empty((n,), np.float32)
        ops["csel"] = np.zeros((n, k), np.float32)
        ops["cin_size"] = np.empty((n, k), np.float32)
        ops["cin_off"] = np.empty((n, k), np.float32)
    for u in np.unique(uid):
        m = uid == u
        op, space = ns.unique[u], ns.spaces[u]
        sub = genes[m]
        base = encode_genes_base(op, space, sub, num_pes=pes[m],
                                 noc_bw=bw[m])
        for key in ("sizes", "offsets", "rank", "sp"):
            ops[key][m] = base[key]
        ops["ext"][m] = ns.ext_row(u)[None, :]
        if spec.cluster:
            tb = gene_tables(op, space)
            if tb.cluster_is_none[sub[:, 2]].any():
                raise ValueError("1-level rows passed to a 2-level spec")
            ops["csize"][m] = tb.csize_tab[sub[:, 2]]
            cand = ns.cand_of_option(u)[sub[:, 2]]
            sel = np.zeros((sub.shape[0], len(spec.cluster)), np.float32)
            sel[np.arange(sub.shape[0]), cand] = 1.0
            ops["csel"][m] = sel
            cin_s, cin_o = ns.cin_rows(u)
            ops["cin_size"][m] = cin_s[None, :]
            ops["cin_off"][m] = cin_o[None, :]
    return ops


def _rep_key(cls) -> str:
    rep = cls.rep
    return f"{rep.name}|{sorted(rep.dims.items())}|{rep.op_type}"


def evaluate_rows(ns: NetSpace, uid: np.ndarray, genes: np.ndarray, *,
                  objective: str = "edp", num_pes, noc_bw,
                  block: int = 1024, n_devices: int | None = None,
                  depth: int = 2, multicast: bool = True,
                  spatial_reduction: bool = True,
                  hw_tail: HWTail | None = None, run: GeneRun | None = None,
                  ckpt: SweepCheckpoint | None = None,
                  retry: RetryPolicy | None = None,
                  device: str | torch.device | None = None,
                  _splits_left: int | None = None
                  ) -> tuple[np.ndarray, np.ndarray]:
    """Evaluate (layer, candidate) rows of ONE op-class through the
    shape-as-operand evaluator on ``device`` (``cuda`` unless the caller
    asks for another; raises without a GPU): ≤ 2 warm-up passes (1-level +
    2-level family) no matter how many layers/structure groups the rows
    span.  Returns ``(vals, cols)`` aligned with the input rows;
    ``num_pes``/``noc_bw`` may be scalars or per-row arrays (network
    co-DSE).

    Resilience mirrors ``universal.evaluate_genes``: chunks run under
    ``retry`` (transient failures re-dispatch with backoff, OOM halves
    the block recursively on one device, exhaustion raises
    ``DeviceError``), and with ``ckpt`` the (vals, cols, cursor)
    accumulators persist every few chunks so a killed pass resumes
    bit-identically — the outputs are direct-indexed by row, so resume
    order cannot change them."""
    col, maximize = OBJECTIVES[objective]
    uid = np.asarray(uid, np.int64)
    genes = np.asarray(genes, np.int64)
    n = genes.shape[0]
    cls = ns.classes[ns.class_of[uid[0]]]
    if any(ns.class_of[u] != ns.class_of[uid[0]] for u in np.unique(uid)):
        raise ValueError("evaluate_rows: rows must share one op-class")
    devs = _devices(device, n_devices)
    nd = len(devs)
    run = run if run is not None else GeneRun()
    run.n_rows += n
    run.n_devices = max(run.n_devices, nd)
    pes = np.broadcast_to(np.asarray(num_pes, np.float32), (n,))
    bw = np.broadcast_to(np.asarray(noc_bw, np.float32), (n,))

    # 2-level membership: option slots are uniform across the class
    tb0 = gene_tables(ns.unique[uid[0]], ns.spaces[uid[0]])
    is2 = ~tb0.cluster_is_none[genes[:, 2]]

    vals = np.empty(n, np.float64)
    cols = np.empty((n, len(COLS)), np.float64)
    t_start = time.perf_counter()

    met = obs.metrics()
    met.inc("netspace.rows_evaluated", n)
    n_compiles_at_entry = run.n_compiles
    nv_entry = run.n_valid      # ``run`` may be shared across calls —
    c0 = compile_count()        # checkpoint state is entry-relative
    retry = retry or default_policy()
    splits_left = retry.max_splits if _splits_left is None else _splits_left

    # -- resilience state: resume cursor + periodic checkpoint ----------
    start_cursor = 0
    chunks_done = 0
    gidx = 0
    ckpt_meta: dict | None = None
    if ckpt is not None:
        ckpt_meta = {"key": ckpt.key, "n": int(n), "block": int(block),
                     "nd": int(nd), "objective": objective,
                     "content": array_hash(uid, genes, pes, bw)}
        st = ckpt.load(ckpt_meta)
        if st is not None:
            start_cursor = chunks_done = int(st["cursor"])
            run.n_valid = nv_entry + int(st["n_valid"])
            vals[:] = st["vals"]
            cols[:] = st["cols"]

    def ckpt_state() -> dict:
        return {"cursor": chunks_done, "n_valid": run.n_valid - nv_entry,
                "vals": vals, "cols": cols}

    def split_eval(sub: np.ndarray) -> None:
        # OOM recovery: same rows, half the block, one device; outputs
        # are direct-indexed by row so the merge is bit-transparent
        rrun = GeneRun()
        v, c = evaluate_rows(
            ns, uid[sub], genes[sub], objective=objective,
            num_pes=pes[sub], noc_bw=bw[sub],
            block=max(retry.min_rows, block // 2), n_devices=1,
            depth=depth, multicast=multicast,
            spatial_reduction=spatial_reduction, hw_tail=hw_tail,
            run=rrun, retry=retry, device=devs[0],
            _splits_left=splits_left - 1)
        vals[sub] = v
        cols[sub] = c
        run.n_valid += rrun.n_valid
        run.n_steady += rrun.n_steady
        run.n_compiles += rrun.n_compiles
        run.compile_s += rrun.compile_s
        run.eval_s += rrun.eval_s
        run.encode_s += rrun.encode_s

    def collect(sub: np.ndarray, m: int, out) -> None:
        # the blocked wait for (and host copy of) this chunk's reduced
        # device results — the host-visible tail of the device pass
        shards, events = out
        with obs.span("device-pass", op=cls.rep.name, rows=m, devices=nd):
            t0 = time.perf_counter()
            for ev in events:
                ev.synchronize()
            host = {kk: np.stack([s[kk].cpu().numpy() for s in shards])
                    for kk in shards[0]}
            dt = time.perf_counter() - t0
        run.eval_s += dt
        met.observe("netspace.collect_wait_s", dt)
        met.inc("netspace.merge_bytes",
                sum(v.nbytes for v in host.values()))
        chunk_rows = nd * block
        vals[sub] = host["vals"].reshape(chunk_rows)[:m]
        cols[sub] = host["cols"].reshape(chunk_rows, len(COLS))[:m]
        run.n_valid += int(np.sum(host["n_valid"]))

    for spec, fam in ((cls.spec1, np.where(~is2)[0]),
                      (cls.spec2, np.where(is2)[0])):
        if fam.size == 0:
            continue
        assert spec is not None
        fam_label = f"{cls.rep.name}:L{2 if spec.cluster else 1}"
        chunk_rows = nd * block
        reduce = ReduceSpec(objective=col, maximize=maximize,
                            k=1, return_vals=True, pareto=False,
                            hw=hw_tail, cols=COLS)
        f = universal_reduced_evaluator(
            cls.rep, spec, reduce, multicast=multicast,
            spatial_reduction=spatial_reduction)
        wk = ("netspace", _rep_key(cls), spec, reduce, multicast,
              spatial_reduction, nd, chunk_rows, devs[0].type)
        pending: collections.deque = collections.deque()

        def make_chunk(sub, m, in_flight):
            with obs.span("encode", family=fam_label, rows=m):
                t0 = time.perf_counter()
                batch = _encode_rows(ns, cls, uid[sub], genes[sub], spec,
                                     pes=pes[sub], bw=bw[sub])
                pad = chunk_rows - m
                live = np.zeros(chunk_rows, np.float32)
                live[:m] = 1.0
                batch = {kk: _pad_rows(v, pad) for kk, v in batch.items()}
                batch["live"] = live
                # one host-to-device copy per operand onto each shard's
                # device
                shards = [_to_device({kk: v[d * block:(d + 1) * block]
                                      for kk, v in batch.items()}, dev)
                          for d, dev in enumerate(devs)]
                t_enc = time.perf_counter() - t0
                run.encode_s += t_enc
            if in_flight:
                # double-buffer overlap, measured not guessed: host
                # encode time spent while >= 1 chunk was in flight
                met.inc("netspace.overlap_encode_s", t_enc)
            met.observe("netspace.chunk_occupancy", m / chunk_rows)
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
                    met.observe("netspace.dispatch_s",
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
                collect(sub, m, dispatch(make_chunk(sub, m, False), m))
            run_attempts(once, policy=retry,
                         label=f"{fam_label} chunk", first_exc=exc)

        def finish(sub, m, out, t_disp):
            nonlocal chunks_done
            try:
                collect(sub, m, out)
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
    run.e2e_s += time.perf_counter() - t_start
    return vals, cols


def evaluate_candidates(ns: NetSpace, cand: Sequence[np.ndarray], *,
                        objective: str = "edp", num_pes, noc_bw,
                        block: int = 1024, n_devices: int | None = None,
                        multicast: bool = True,
                        spatial_reduction: bool = True,
                        dedupe: bool = True,
                        device: str | torch.device | None = None
                        ) -> NetEval:
    """Evaluate per-unique-layer candidate gene matrices for the whole
    network on ``device`` (``cuda`` unless the caller asks for another):
    one device pass per (op-class, level-count), analysis-equivalent
    candidates collapsed per layer (``dedupe=True``; disable when
    ``num_pes``/``noc_bw`` are per-row arrays, where equal genes may
    carry different hardware points).

    ``cand[u]`` is the ``(n_u, G)`` candidate matrix of unique layer
    ``u``; ``num_pes``/``noc_bw`` are scalars or per-unique-layer arrays
    aligned with ``cand``."""
    run = GeneRun()
    vals: list[np.ndarray] = [np.empty(0, np.float64)] * len(ns.unique)
    cols: list[np.ndarray] = [np.empty((0, len(COLS)),
                                       np.float64)] * len(ns.unique)
    per_row_hw = isinstance(num_pes, (list, tuple))
    for cls in ns.classes:
        jobs = []  # (uid, rep rows, back map, per-row pes, per-row bw)
        for u in cls.members:
            g = np.asarray(cand[u], np.int64)
            if not g.shape[0]:
                continue
            if dedupe:
                reps, back = dedupe_equivalent_genes(
                    ns.unique[u], ns.spaces[u], g)
            else:
                reps = back = np.arange(g.shape[0])
            p = b = None
            if per_row_hw:
                p = np.broadcast_to(np.asarray(num_pes[u], np.float32),
                                    (g.shape[0],))[reps]
                b = np.broadcast_to(np.asarray(noc_bw[u], np.float32),
                                    (g.shape[0],))[reps]
            jobs.append((u, g[reps], back, p, b))
        if not jobs:
            continue
        uid = np.concatenate([np.full(g.shape[0], u, np.int64)
                              for u, g, *_ in jobs])
        genes = np.concatenate([g for _, g, *_ in jobs])
        v, c = evaluate_rows(
            ns, uid, genes, objective=objective,
            num_pes=np.concatenate([p for *_, p, _ in jobs])
            if per_row_hw else num_pes,
            noc_bw=np.concatenate([b for *_, b in jobs])
            if per_row_hw else noc_bw,
            block=block, n_devices=n_devices, multicast=multicast,
            spatial_reduction=spatial_reduction, run=run, device=device)
        at = 0
        for u, g, back, *_ in jobs:
            vals[u] = v[at:at + g.shape[0]][back]
            cols[u] = c[at:at + g.shape[0]][back]
            at += g.shape[0]
    return NetEval(vals=vals, cols=cols, run=run)
