"""Mapping-space search strategies behind one ``search()`` API.

Four strategies, auto-selected by space size vs budget:

  * ``exhaustive`` — every point, when the space fits the budget;
  * ``random`` — uniform sampling over the whole space;
  * ``greedy`` — hill-climbing refinement of the random phase's best
    point: neighbors mutate one gene at a time, *including* structural
    genes (spatial / permutation / cluster);
  * ``genetic`` — crossover + mutation over the gene encoding with large
    populations.

Two execution pipelines share the strategies:

  * ``pipeline="gene"`` (default) — integer **gene matrices** are the
    native currency end to end: vectorized enumeration/sampling
    (``space.enumerate_genes`` / ``sample_genes``), vectorized
    budget-pruning and equivalence-dedupe, numpy-gather operand encoding
    (``universal.encode_genes``), double-buffered dispatch striped over
    CUDA devices, and the objective/top-k reduction on the device
    (``universal.evaluate_genes``).  The host never sees a full feature
    matrix — only the objective column and k winner rows.
  * ``pipeline="legacy"`` — the tuple-point path (per-point Python encode
    + host numpy reduction), kept intact as a parity oracle and
    baseline: both pipelines evaluate identical candidate sets under a
    fixed seed and must report matching top-k values.

The genetic strategy's selection/crossover/mutation run over gene
matrices with a ``torch.Generator`` seeded from ``seed`` in the gene
pipeline (the legacy pipeline keeps the original numpy loop).  The
reference draws those children with ``jax.random``, so the port's genetic
search is deterministic under its seed but not bit-equal to the
reference's; ``exhaustive``, ``random`` and ``greedy`` draw with numpy in
both packages and are.

Everything is deterministic under ``seed`` — including the striped gene
pipeline, whose per-device top-k merge is by (value, global index) and so
yields identical results at any device count.  Objective values come
from the batched feature vector (``core.vectorized.FEATURES``);
lower-is-better except throughput.  The search runs on ``device``
(``cuda`` unless the caller asks for another) and raises without a GPU
rather than run elsewhere.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Any, Sequence

import numpy as np
import torch

from ..core.directives import Dataflow
from ..core.tensor_analysis import LayerOp
from ..core.vectorized import FEATURES
from ..devices import resolve_device
from ..resilience import SpecError, SweepCheckpoint
from . import cache as _cache
from .batched import FEATURE_INDEX, EvalStats, evaluate_points
from .space import (MapSpace, Point, build_space, dedupe_equivalent_genes,
                    dedupe_equivalent_points, enumerate_genes,
                    enumerate_points, flat_index, point_dataflow,
                    points_from_genes, prune_by_budget,
                    prune_genes_by_budget, sample_genes, sample_points)
from .universal import evaluate_genes

# objective -> (feature column, maximize?)
OBJECTIVES = {
    "edp": ("edp", False),
    "energy": ("energy_pj", False),
    "runtime": ("runtime", False),
    "throughput": ("throughput", True),
}

STRATEGIES = ("exhaustive", "random", "greedy", "genetic")
PIPELINES = ("gene", "legacy")


@dataclasses.dataclass
class SearchResult:
    objective: str
    strategy: str
    space: MapSpace
    best_point: Point
    best_value: float
    best_stats: dict[str, float]
    top_k: list[dict[str, Any]]       # [{point, value, stats}]
    n_evaluated: int
    n_groups: int
    elapsed_s: float
    eval_s: float
    compile_s: float
    n_steady: int = 0                 # rows in steady-timed batched calls
    n_compiles: int = 0               # first (warm-up) passes: the port
    #                                   compiles nothing; it counts the
    #                                   first pass of each (spec, block)
    #                                   shape where the reference compiles
    cached: bool = False
    pipeline: str = "legacy"
    encode_s: float = 0.0             # host operand-encode time
    n_devices: int = 1
    wall_s: float = 0.0               # original search wall (survives the
    #                                   result cache, unlike elapsed_s)

    @property
    def best_dataflow(self) -> Dataflow:
        return point_dataflow(self.space, self.best_point)

    @property
    def mappings_per_s(self) -> float:
        """Steady-state batched evaluation rate, on the SAME definition as
        :class:`EvalStats.mappings_per_s`: steady-timed rows (padding and
        first (warm-up) passes excluded) over steady evaluation time."""
        if not self.n_steady:
            return 0.0
        return self.n_steady / max(self.eval_s, 1e-9)

    @property
    def end_to_end_mappings_per_s(self) -> float:
        """User-observable throughput: evaluated mappings over the FULL
        search wall time — enumeration/sampling, pruning, dedupe, operand
        encode, dispatch and reduction — excluding only the one-off
        warm-up passes (``compile_s``).  This is the number to compare
        against the paper's 0.17M designs/s.
        Quoted on the ORIGINAL run's wall (``wall_s``) so a result-cache
        hit reports the rate of the search it replays, not of the cache
        load."""
        denom = self.wall_s - self.compile_s
        if denom <= 0:
            return 0.0
        return self.n_evaluated / denom


def _objective_column(feats: np.ndarray, objective: str) -> np.ndarray:
    col, maximize = OBJECTIVES[objective]
    v = feats[:, FEATURE_INDEX[col]].astype(np.float64)
    v = np.where(np.isfinite(v), v, np.inf if not maximize else -np.inf)
    return -v if maximize else v  # canonical: minimize


def _stats_dict(row: np.ndarray) -> dict[str, float]:
    return {name: float(row[i]) for i, name in enumerate(FEATURES)}


def _neighbors(space: MapSpace, pt: Point) -> list[Point]:
    """One-gene mutations.  Structural genes (spatial / perm / cluster)
    move freely: with the universal evaluator a new structure group is just
    a different operand pattern, not a new evaluator."""
    ranges = space.gene_ranges()
    out = []
    for gi in range(len(pt)):
        for delta in (-1, 1):
            g = pt[gi] + delta
            if not 0 <= g < ranges[gi]:
                continue
            out.append(pt[:gi] + (g,) + pt[gi + 1:])
    return out


def _neighbor_genes(space: MapSpace, row: np.ndarray) -> np.ndarray:
    """Vectorized :func:`_neighbors` over one gene row."""
    ranges = np.asarray(space.gene_ranges(), np.int64)
    g = len(ranges)
    eye = np.eye(g, dtype=np.int64)
    cand = np.stack([row[None] - eye, row[None] + eye], axis=1)
    cand = cand.reshape(2 * g, g)            # g0-1, g0+1, g1-1, ...
    ok = np.all((cand >= 0) & (cand < ranges[None, :]), axis=1)
    return cand[ok]


def _random_point(space: MapSpace, rng: np.random.Generator) -> Point:
    return tuple(int(rng.integers(r)) for r in space.gene_ranges())


# ----------------------------------------------------------------------
# Legacy tuple-point pipeline (parity oracle / baseline)
# ----------------------------------------------------------------------

def _genetic_loop(space: MapSpace, rng: np.random.Generator, budget: int,
                  run, evaluated: dict[Point, float], *,
                  population: int, mutate_p: float = 0.15,
                  tournament: int = 3) -> None:
    """Crossover + mutation over the gene encoding.  Large populations are
    practical because structural genes need no new evaluator — the whole
    generation is one batched evaluate call."""
    ranges = space.gene_ranges()
    population = max(4, min(population, budget))
    run(sample_points(space, rng, population))
    stalls = 0
    while len(evaluated) < budget and evaluated and stalls < 8:
        before = len(evaluated)
        pool = sorted(evaluated, key=evaluated.get)[:population]

        def pick() -> Point:
            idx = rng.integers(len(pool), size=tournament).min()
            return pool[int(idx)]

        children: list[Point] = []
        seen: set[Point] = set()
        attempts = 0
        want = min(population, budget - len(evaluated))
        while len(children) < want and attempts < 20 * want:
            attempts += 1
            a, b = pick(), pick()
            mask = rng.random(len(ranges))
            child = tuple(
                (int(rng.integers(r)) if m < mutate_p else
                 (ga if m < (1 + mutate_p) / 2 else gb))
                for ga, gb, m, r in zip(a, b, mask, ranges))
            if child in seen or child in evaluated:
                continue
            seen.add(child)
            children.append(child)
        if not children:
            # population converged: re-seed with fresh uniform points
            children = sample_points(space, rng, want, exclude=set(evaluated))
            if not children:
                break
        run(children)
        # budget pruning may silently drop every child: bound the loop so
        # a feasible set smaller than the budget terminates instead of
        # spinning forever
        stalls = stalls + 1 if len(evaluated) == before else 0


def _search_legacy(op, space, rng, objective, budget, strategy, *,
                   refine_frac, population, l1_budget_kb, l2_budget_kb,
                   ev, stats) -> tuple[dict, dict, str]:
    """The tuple-point path: per-point encode, host numpy objective —
    kept as the gene pipeline's parity oracle and baseline.  Candidate
    generation (enumeration order, uniform sampling draws, neighbor
    order) is shared with the gene pipeline so a fixed seed yields
    identical candidate sets in both; only the genetic strategy's child
    generation differs (numpy loop here, a ``torch.Generator`` there)."""
    evaluated: dict[Point, float] = {}
    rows: dict[Point, np.ndarray] = {}

    def run(points: Sequence[Point]) -> None:
        points = [p for p in points if p not in evaluated]
        points = prune_by_budget(op, space, points, l1_kb=l1_budget_kb,
                                 l2_kb=l2_budget_kb)
        if not points:
            return
        # analysis-equivalent permutations collapse to one evaluated row
        reps, back = dedupe_equivalent_points(op, space, points)
        feats, st = evaluate_points(op, space, reps, **ev)
        stats.merge(st)
        vals = _objective_column(feats, objective)
        for i, p in enumerate(points):
            evaluated[p] = float(vals[back[i]])
            rows[p] = feats[back[i]]

    if strategy == "exhaustive":
        pts = list(itertools.islice(enumerate_points(space), budget))
        if space.size > budget:
            # enumerate_points orders structural genes outermost, so the
            # kept prefix only covers the leading structure group(s) — say
            # so rather than reporting a full sweep
            strategy = "exhaustive[truncated]"
        run(pts)
    elif strategy == "genetic":
        pop = population or max(32, min(10_000, budget // 4))
        _genetic_loop(space, rng, budget, run, evaluated, population=pop)
    else:
        n_refine = int(budget * refine_frac) if strategy == "greedy" else 0
        run(points_from_genes(
            sample_genes(space, rng, budget - n_refine)))
        if strategy == "greedy" and evaluated:
            spent_guard = 0
            while len(evaluated) < budget and spent_guard < 64:
                spent_guard += 1
                best = min(evaluated, key=evaluated.get)
                nbrs = [p for p in _neighbors(space, best)
                        if p not in evaluated][:budget - len(evaluated)]
                if not nbrs:
                    break
                run(nbrs)
                if evaluated[min(evaluated, key=evaluated.get)] >= \
                        evaluated[best]:
                    break  # converged: no neighbor improved
    return evaluated, rows, strategy


def static_candidates(space: MapSpace, strategy: str, budget: int,
                      seed: int) -> tuple[np.ndarray, str]:
    """The candidate gene matrix a NON-adaptive search evaluates:
    ``exhaustive`` (or ``auto`` with the space inside the budget) yields
    the first ``budget`` enumerated rows; ``random`` (or ``auto``
    otherwise) yields ``sample_genes`` draws from a fresh
    ``default_rng(seed)``.  For an EXPLICIT ``exhaustive``/``random``
    strategy these are the exact candidate sets ``search()`` evaluates
    under the same seed — the ``repro.netspace`` parity guarantee.  Note
    the ``auto`` fallbacks differ: ``search()`` escalates an oversized
    space to adaptive ``greedy`` refinement, which a one-pass batch
    evaluator cannot replay, so ``auto`` here falls back to ``random``.
    Returns ``(genes, resolved_strategy)``."""
    if strategy == "auto":
        strategy = "exhaustive" if space.size <= budget else "random"
    if strategy == "exhaustive":
        if space.size > budget:
            return (enumerate_genes(space, 0, budget),
                    "exhaustive[truncated]")
        return enumerate_genes(space), "exhaustive"
    if strategy == "random":
        rng = np.random.default_rng(seed)
        return sample_genes(space, rng, budget), "random"
    raise ValueError(f"static_candidates: strategy must be auto/"
                     f"exhaustive/random, got {strategy!r}")


# ----------------------------------------------------------------------
# Gene-matrix pipeline (default)
# ----------------------------------------------------------------------

def _gene_children(gen: torch.Generator, pool: torch.Tensor,
                   ranges: tuple, n: int, mutate_p: float = 0.15,
                   tournament: int = 3) -> torch.Tensor:
    """Genetic step over a val-sorted (best-first) gene pool: min-index
    tournament selection, uniform crossover, per-gene uniform mutation,
    drawn from ``gen`` on the host.  The reference draws the same steps
    with ``jax.random`` on the device, so the two children differ; each
    is deterministic under its seed."""
    p = pool.shape[0]
    ia = torch.randint(0, p, (n, tournament), generator=gen).min(1).values
    ib = torch.randint(0, p, (n, tournament), generator=gen).min(1).values
    a, b = pool[ia], pool[ib]
    m = torch.rand((n, pool.shape[1]), generator=gen, dtype=torch.float64)
    r = torch.as_tensor(ranges, dtype=torch.float64)
    rand_g = torch.floor(
        torch.rand(m.shape, generator=gen, dtype=torch.float64) * r
    ).to(pool.dtype)
    return torch.where(m < mutate_p, rand_g,
                       torch.where(m < (1.0 + mutate_p) / 2.0, a, b))


class _GeneSearch:
    """Search state over gene matrices: distinctness via flat indices,
    values host-resident as one scalar column, features never
    materialized beyond the final top-k rows."""

    def __init__(self, op, space, objective, *, l1_kb, l2_kb, ev, stats,
                 budget, ckpt_factory=None):
        self.op, self.space = op, space
        self.col, self.maximize = OBJECTIVES[objective]
        self.l1_kb, self.l2_kb = l1_kb, l2_kb
        self.ev, self.stats = ev, stats
        self.budget = budget
        # checkpointing: every evaluate_genes call this search issues is
        # numbered; the search path is deterministic under (seed, space),
        # so a resumed process replays the same call sequence and call i
        # finds call i's checkpoint (earlier completed calls re-execute
        # warm — bounded loss, bit-identical results)
        self.ckpt_factory = ckpt_factory
        self.call_seq = 0
        self.seen = np.empty(0, np.int64)      # sorted flat indices
        self.genes: list[np.ndarray] = []
        self.vals: list[np.ndarray] = []
        self.n = 0
        self.best_val = np.inf
        self.best_row: np.ndarray | None = None

    def run(self, g: np.ndarray) -> int:
        """Evaluate the not-yet-seen rows of ``g``; returns how many new
        rows received values."""
        g = np.asarray(g, np.int64).reshape(-1, len(
            self.space.gene_ranges()))
        if not g.shape[0]:
            return 0
        flat = flat_index(self.space, g)
        _, first = np.unique(flat, return_index=True)
        first = np.sort(first)                  # first occurrence, in order
        g, flat = g[first], flat[first]
        fresh = ~np.isin(flat, self.seen, assume_unique=True)
        g, flat = g[fresh], flat[fresh]
        g, flat = (g[:max(self.budget - self.n, 0)],
                   flat[:max(self.budget - self.n, 0)])
        if not g.shape[0]:
            return 0
        kept = prune_genes_by_budget(self.op, self.space, g,
                                     l1_kb=self.l1_kb, l2_kb=self.l2_kb)
        if kept.shape[0] != g.shape[0]:
            flat = flat_index(self.space, kept)
        g = kept
        if not g.shape[0]:
            return 0
        reps, back = dedupe_equivalent_genes(self.op, self.space, g)
        ckpt = (self.ckpt_factory(self.call_seq)
                if self.ckpt_factory else None)
        self.call_seq += 1
        res = evaluate_genes(self.op, self.space, g[reps],
                             objective=self.col, maximize=self.maximize,
                             return_vals=True, pareto=False, ckpt=ckpt,
                             **self.ev)
        v = res.vals[back]
        self.seen = np.union1d(self.seen, flat)
        self.genes.append(g)
        self.vals.append(v)
        self.n += g.shape[0]
        groups = np.unique(g[:, :3], axis=0)
        self.stats.merge(EvalStats(
            n_points=g.shape[0], n_groups=groups.shape[0],
            n_steady=res.run.n_steady, n_compiles=res.run.n_compiles,
            compile_s=res.run.compile_s, eval_s=res.run.eval_s,
            encode_s=res.run.encode_s))
        i = int(np.argmin(v))
        # all-inf chunks still seed the incumbent (first insertion order,
        # like the legacy dict min) so greedy never climbs from None
        if self.best_row is None or v[i] < self.best_val:
            self.best_val = float(v[i])
            self.best_row = g[i]
        return g.shape[0]

    def all(self) -> tuple[np.ndarray, np.ndarray]:
        return (np.concatenate(self.genes) if self.genes
                else np.empty((0, 0), np.int64),
                np.concatenate(self.vals) if self.vals
                else np.empty((0,)))


def _search_genes(op, space, rng, objective, budget, strategy, *, seed,
                  refine_frac, population, st: _GeneSearch) -> str:
    if strategy == "exhaustive":
        if space.size > budget:
            strategy = "exhaustive[truncated]"
        # like the legacy islice: the first `budget` enumerated points,
        # whether or not budget pruning later drops some of them
        end = min(space.size, budget)
        step = max(65536, st.ev["block"] * 8)
        for lo in range(0, end, step):
            st.run(enumerate_genes(space, lo, min(lo + step, end)))
    elif strategy == "genetic":
        pop = max(4, min(population or max(32, min(10_000, budget // 4)),
                         budget))
        st.run(sample_genes(space, rng, pop))
        gen = torch.Generator().manual_seed(seed)
        ranges = tuple(int(r) for r in space.gene_ranges())
        stalls = 0
        while st.n < budget and st.n and stalls < 8:
            before = st.n
            allg, allv = st.all()
            order = np.argsort(allv, kind="stable")[:pop]
            pool = allg[order]
            if pool.shape[0] < pop:   # pad to a fixed pool shape
                pool = np.concatenate(
                    [pool, np.repeat(pool[-1:], pop - pool.shape[0], 0)])
            want = min(pop, budget - st.n)
            children = _gene_children(
                gen, torch.from_numpy(pool.astype(np.int32)), ranges,
                pop).numpy()[:want]
            st.run(children)
            if st.n == before:        # converged: re-seed fresh uniform
                st.run(sample_genes(space, rng, want,
                                    exclude_flat=st.seen))
            stalls = stalls + 1 if st.n == before else 0
    else:
        n_refine = int(budget * refine_frac) if strategy == "greedy" else 0
        st.run(sample_genes(space, rng, budget - n_refine))
        if strategy == "greedy" and st.n:
            spent_guard = 0
            while st.n < budget and spent_guard < 64:
                spent_guard += 1
                prev_best = st.best_val
                nbrs = _neighbor_genes(space, st.best_row)
                if not st.run(nbrs[:budget - st.n]):
                    break
                if st.best_val >= prev_best:
                    break  # converged: no neighbor improved
    return strategy


def search(op: LayerOp, objective: str = "edp", budget: int = 2000,
           **kwargs) -> SearchResult:
    """Search the mapping space of ``op`` for the best dataflow at a fixed
    hardware point — a thin wrapper over the declarative session path
    (``repro_torch.api``): the shared default session keeps the query
    count and forwards verbatim to :func:`search_impl` (bit-equal by
    construction; see ``tests/test_torch_api.py``).  Accepts exactly
    :func:`search_impl`'s keywords; runs on ``cuda`` unless ``device``
    names another device."""
    from ..api.session import default_session
    return default_session().run_search(op, objective=objective,
                                        budget=budget, **kwargs)


def search_impl(op: LayerOp, objective: str = "edp", budget: int = 2000,
                *, space: MapSpace | None = None, num_pes: int = 256,
                noc_bw: float = 32.0, strategy: str = "auto",
                seed: int = 0,
                top_k: int = 8,
                refine_frac: float = 0.3, block: int = 1024,
                population: int | None = None,
                l1_budget_kb: float | None = None,
                l2_budget_kb: float | None = None,
                cache_dir: str | None = None,
                pipeline: str = "gene", devices: int | None = None,
                multicast: bool = True, spatial_reduction: bool = True,
                cache_extra: str = "",
                ckpt_dir: str | None = None,
                device: str | torch.device | None = None) -> SearchResult:
    """The per-layer mapping-search engine behind :func:`search` and
    ``repro_torch.api.Session``.
    ``budget`` caps evaluated mappings; ``strategy`` is ``auto`` or one of
    ``exhaustive`` / ``random`` / ``greedy`` / ``genetic``.  It runs on
    ``device`` (``cuda`` unless the caller asks for another) and raises
    without a GPU rather than run elsewhere.

    ``pipeline="gene"`` (default) runs the gene-matrix pipeline —
    vectorized host side, reduction on the device, chunks striped over
    ``devices`` CUDA devices (default all) with double buffering.
    ``pipeline="legacy"`` is the tuple-point parity oracle.  Both are
    deterministic under ``seed`` and evaluate identical candidate sets for
    ``exhaustive``; sampling draws also coincide across pipelines except
    for the genetic strategy (whose gene-pipeline children come from a
    ``torch.Generator``, and so differ from the reference's
    ``jax.random`` children).

    ``l1_budget_kb``/``l2_budget_kb`` drop over-budget tile sets before
    evaluation.  ``cache_extra`` is an opaque component of the disk-cache
    key (the session path passes the full ``Query`` fingerprint).

    With ``ckpt_dir``, every gene-pipeline evaluation pass checkpoints
    under a key derived from the result-cache key, so a killed search
    resumes from the last chunk boundary bit-identically (rerun the same
    call after the kill)."""
    if objective not in OBJECTIVES:
        raise SpecError(f"objective must be one of {sorted(OBJECTIVES)}",
                        field="objective")
    if pipeline not in PIPELINES:
        raise SpecError(f"pipeline must be one of {PIPELINES}",
                        field="pipeline")
    dev = resolve_device(device)
    space = space or build_space(op)
    rng = np.random.default_rng(seed)
    t_start = time.perf_counter()

    if strategy == "auto":
        strategy = "exhaustive" if space.size <= budget else "greedy"
    if strategy not in STRATEGIES:
        raise SpecError(f"unknown strategy {strategy!r}", field="strategy")

    key = _cache.search_key(
        op, space, num_pes, noc_bw, objective, budget, strategy, seed,
        extra=f"mc={multicast},sr={spatial_reduction},"
              f"rf={refine_frac},blk={block},tk={top_k},"
              f"pop={population},l1={l1_budget_kb},l2={l2_budget_kb},"
              f"pipe={pipeline},dev={dev.type},q={cache_extra}")
    hit = _cache.load(cache_dir, key)
    if hit is not None:
        return SearchResult(
            objective=objective, strategy=hit["strategy"], space=space,
            best_point=tuple(hit["best_point"]),
            best_value=hit["best_value"], best_stats=hit["best_stats"],
            top_k=[{"point": tuple(e["point"]), "value": e["value"],
                    "stats": e["stats"]} for e in hit["top_k"]],
            n_evaluated=hit["n_evaluated"], n_groups=hit["n_groups"],
            elapsed_s=time.perf_counter() - t_start,
            eval_s=hit["eval_s"], compile_s=hit["compile_s"],
            n_steady=hit.get("n_steady", 0),
            n_compiles=hit.get("n_compiles", 0), cached=True,
            pipeline=hit.get("pipeline", pipeline),
            encode_s=hit.get("encode_s", 0.0),
            n_devices=hit.get("n_devices", 1),
            wall_s=hit.get("wall_s", 0.0))

    stats = EvalStats()
    n_devices = 1
    if pipeline == "legacy":
        ev = dict(num_pes=num_pes, noc_bw=noc_bw, block=block,
                  multicast=multicast, spatial_reduction=spatial_reduction,
                  device=dev)
        evaluated, rows, strategy = _search_legacy(
            op, space, rng, objective, budget, strategy,
            refine_frac=refine_frac, population=population,
            l1_budget_kb=l1_budget_kb, l2_budget_kb=l2_budget_kb,
            ev=ev, stats=stats)
        if not evaluated:
            raise RuntimeError("search evaluated no mappings "
                               "(empty space, or budgets pruned "
                               "everything?)")
        groups = {space.group_key(p) for p in evaluated}
        n_groups = len(groups)
        order_pts = sorted(evaluated, key=evaluated.get)
        top_pts = order_pts[:top_k]
        top_vals = [evaluated[p] for p in top_pts]
        top_feats = [rows[p] for p in top_pts]
    else:
        ev = dict(num_pes=num_pes, noc_bw=noc_bw, block=block,
                  multicast=multicast,
                  spatial_reduction=spatial_reduction,
                  n_devices=devices, k=top_k, device=dev)
        ckpt_factory = None
        if ckpt_dir:
            ckpt_factory = lambda seq: SweepCheckpoint(  # noqa: E731
                ckpt_dir, f"{key[:20]}-c{seq}", every_chunks=1)
        st = _GeneSearch(op, space, objective, l1_kb=l1_budget_kb,
                         l2_kb=l2_budget_kb, ev=ev, stats=stats,
                         budget=budget, ckpt_factory=ckpt_factory)
        strategy = _search_genes(op, space, rng, objective, budget,
                                 strategy, seed=seed,
                                 refine_frac=refine_frac,
                                 population=population, st=st)
        if not st.n:
            raise RuntimeError("search evaluated no mappings "
                               "(empty space, or budgets pruned "
                               "everything?)")
        allg, allv = st.all()
        groups = np.unique(allg[:, :3], axis=0)
        n_groups = groups.shape[0]
        order = np.argsort(allv, kind="stable")[:top_k]
        top_pts = [tuple(int(x) for x in allg[i]) for i in order]
        top_vals = [float(allv[i]) for i in order]
        # one small pass fetches the winners' feature rows — the only
        # full feature rows the gene pipeline ever materializes
        fin = evaluate_genes(op, space, allg[order], objective=st.col,
                             maximize=st.maximize, return_vals=True,
                             pareto=False, **ev)
        by_row = {t["row"]: t["feats"] for t in fin.top}
        top_feats = [by_row[i] for i in range(len(order))]
        n_devices = fin.run.n_devices
        n_evaluated = st.n

    _, maximize = OBJECTIVES[objective]

    def actual(v: float) -> float:
        return -v if maximize else v

    result = SearchResult(
        objective=objective, strategy=strategy, space=space,
        best_point=top_pts[0], best_value=actual(top_vals[0]),
        best_stats=_stats_dict(top_feats[0]),
        top_k=[{"point": p, "value": actual(v),
                "stats": _stats_dict(f)}
               for p, v, f in zip(top_pts, top_vals, top_feats)],
        n_evaluated=(len(evaluated) if pipeline == "legacy"
                     else n_evaluated),
        n_groups=n_groups,
        elapsed_s=time.perf_counter() - t_start,
        eval_s=stats.eval_s, compile_s=stats.compile_s,
        n_steady=stats.n_steady, n_compiles=stats.n_compiles,
        pipeline=pipeline, encode_s=stats.encode_s,
        n_devices=n_devices,
        wall_s=time.perf_counter() - t_start)

    _cache.store(cache_dir, key, {
        "strategy": result.strategy,
        "best_point": list(result.best_point),
        "best_value": result.best_value,
        "best_stats": result.best_stats,
        "top_k": [{"point": list(e["point"]), "value": e["value"],
                   "stats": e["stats"]} for e in result.top_k],
        "n_evaluated": result.n_evaluated, "n_groups": result.n_groups,
        "eval_s": result.eval_s, "compile_s": result.compile_s,
        "n_steady": result.n_steady, "n_compiles": result.n_compiles,
        "pipeline": result.pipeline, "encode_s": result.encode_s,
        "n_devices": result.n_devices, "wall_s": result.wall_s})
    return result
