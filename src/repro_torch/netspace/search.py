"""Whole-network schedule search (``netspace.search_network``) and the
network-level joint mapping × hardware co-DSE
(``netspace.co_search_network``) — the port of ``repro.netspace.search``.
Every device pass runs on ``device`` (``cuda`` unless the caller asks for
another; without a GPU the entry points raise, never falling back).

Pipeline: build the shared-gene-layout :class:`NetSpace`, generate
per-layer candidates with the SAME draws as per-layer ``search()``
(``mapspace.search.static_candidates`` — the parity guarantee), evaluate
every (unique layer, candidate) row in one device pass per (op-class,
level-count) through the shape-as-operand evaluator, reduce each layer
to a top-``frontier_k`` frontier, and hand the frontiers to the DP (or
genetic) composer for per-layer mapping selection + fused-stack
segmentation under the reconfiguration/off-chip cost model.

The co-DSE crosses the per-layer frontiers with the full (PEs × NoC bw)
grid — hardware as per-row operands of the SAME evaluators, zero extra
warm-up passes — then applies ``core.dse.run_dse``-style network accounting
(SRAM placed for the worst layer, area/power budgets, leakage on total
runtime) and merges an (energy, throughput) frontier via the co-DSE's
``pareto_front``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Sequence

import numpy as np
import torch

from .. import obs
from ..core import dnn_models as zoo
from ..core.dataflows import TABLE3, table3_for_layer
from ..core.dse import DSEConfig
from ..core.model import analyze
from ..core.performance import HWConfig
from ..core.tensor_analysis import LayerOp
from ..devices import resolve_device
from ..mapspace.codse import hw_grid
from ..mapspace.search import OBJECTIVES, static_candidates
from ..mapspace.space import (enumerate_genes, flat_index, point_dataflow,
                              prune_genes_by_budget, sample_genes)
from ..mapspace.universal import pareto_front
from .composer import (CandStat, NetCostModel, NetworkSchedule,
                       compose_dp, compose_genetic, evaluate_schedule)
from .evaluator import evaluate_candidates
from .space import NetSpace, build_netspace, halo_fractions

COMPOSERS = ("dp", "genetic", "auto")
BUDGET_POLICIES = ("uniform", "adaptive")


@dataclasses.dataclass
class NetSearchResult:
    objective: str
    strategy: str
    composer: str
    schedule: NetworkSchedule
    netspace: NetSpace
    frontiers: list[list[CandStat]]    # per unique layer
    model: NetCostModel
    n_evaluated: int                   # (unique layer, candidate) rows
    n_layers: int
    n_unique: int
    n_classes: int
    n_compiles: int
    compile_s: float
    eval_s: float
    encode_s: float
    compose_s: float
    n_transitions: int                 # composer-explored extensions
    elapsed_s: float
    n_devices: int
    budget_policy: str = "uniform"
    refined: tuple[int, ...] = ()      # unique ids the adaptive policy
    #                                    spent extra budget on

    @property
    def network_edp(self) -> float:
        return self.schedule.network_edp

    @property
    def schedules_per_s(self) -> float:
        """Composer throughput: partial-schedule extensions per second
        (each DP transition extends one resident-tile state by one
        layer)."""
        return self.n_transitions / max(self.compose_s, 1e-9)

    def best_dataflow(self, layer_idx: int):
        return point_dataflow(self.netspace.space_for(layer_idx),
                              self.schedule.genes[layer_idx])


def _layers_of(model) -> list[LayerOp]:
    if isinstance(model, str):
        return zoo.MODELS[model]()
    return list(model)


def _eval_objective(objective: str) -> str:
    """Network throughput = total MACs / total runtime with MACs fixed,
    so maximizing it is exactly minimizing total runtime — the additive
    form the composer needs."""
    if objective not in OBJECTIVES:
        raise ValueError(f"objective must be one of {sorted(OBJECTIVES)}")
    return "runtime" if objective == "throughput" else objective


def _frontier(ns: NetSpace, uid: int, genes: np.ndarray,
              vals: np.ndarray, cols: np.ndarray, k: int
              ) -> list[CandStat]:
    order = np.lexsort((np.arange(len(vals)), vals))[:k]
    halo = halo_fractions(ns.unique[uid], ns.spaces[uid], genes[order])
    cls_id = ns.class_of[uid]
    out = []
    for j, i in enumerate(order):
        g = tuple(int(x) for x in genes[i])
        out.append(CandStat(
            gene=g, val=float(vals[i]), runtime=float(cols[i, 0]),
            energy=float(cols[i, 1]), l1_kb=float(cols[i, 2]),
            l2_kb=float(cols[i, 3]), halo=float(halo[j]),
            struct=(cls_id,) + g[:3]))
    return out


def _out_vols(layers: Sequence[LayerOp]) -> list[float]:
    return [float(op.output.volume(op.dims)) for op in layers]


def search_network(model, objective: str = "edp", budget: int = 512,
                   **kwargs) -> NetSearchResult:
    """Whole-network schedule search — the legacy entry point, a thin
    wrapper over the declarative session path (``repro_torch.api``);
    forwards verbatim to :func:`search_network_impl` (bit-equal by
    construction, see ``tests/test_torch_netspace.py``).  Runs on
    ``cuda`` unless ``device`` names another device."""
    from ..api.session import default_session
    return default_session().run_search_network(
        model, objective=objective, budget=budget, **kwargs)


def _adaptive_refine(ns: NetSpace, cand, vals, cols, strats_u, *,
                     budget: int, cheap: int, seed: int,
                     l1_prune_kb, l2_prune_kb, adapt_cover: float
                     ) -> tuple[list[np.ndarray], list[int]]:
    """Pick the unique layers that dominate the cheap first pass's
    network cost and draw their remaining candidate budget.  Returns
    ``(extra_candidate_matrices, refined_unique_ids)`` — extras are
    empty for non-refined layers."""
    reps_n = np.bincount(np.asarray(ns.index), minlength=len(ns.unique))
    contrib = np.empty(len(ns.unique))
    for u in range(len(ns.unique)):
        best = float(np.min(vals[u])) if len(vals[u]) else np.inf
        contrib[u] = reps_n[u] * best
    inf_mask = ~np.isfinite(contrib)
    fin = np.where(inf_mask, 0.0, contrib)
    total = float(fin.sum())
    # infeasible-so-far layers always refine; finite ones by descending
    # network-cost contribution until `adapt_cover` of the total is in
    key = np.where(inf_mask, np.finfo(np.float64).max, fin)
    refined: list[int] = []
    cum = 0.0
    for u in np.argsort(-key, kind="stable"):
        if refined and not inf_mask[u] and total > 0 \
                and cum >= adapt_cover * total:
            break
        refined.append(int(u))
        cum += fin[u]
    extra = [np.empty((0, len(ns.spaces[u].gene_ranges())), np.int64)
             for u in range(len(ns.unique))]
    for u in refined:
        space = ns.spaces[u]
        if strats_u[u].startswith("exhaustive"):
            g = enumerate_genes(space, cheap, min(space.size, budget))
        else:
            g = sample_genes(space, np.random.default_rng([seed, u + 1]),
                             budget - cheap,
                             exclude_flat=flat_index(space, cand[u]))
        if g.shape[0]:
            g = prune_genes_by_budget(ns.unique[u], space, g,
                                      l1_kb=l1_prune_kb,
                                      l2_kb=l2_prune_kb)
        extra[u] = g
    return extra, refined


def search_network_impl(model, objective: str = "edp", budget: int = 512,
                        *, num_pes: int = 256, noc_bw: float = 32.0,
                        seed: int = 0, strategy: str = "auto",
                        frontier_k: int = 8, fuse: bool = True,
                        reconfig: bool = True,
                        l2_budget_kb: float | None = None,
                        l1_prune_kb: float | None = None,
                        l2_prune_kb: float | None = None,
                        hw: HWConfig | None = None,
                        composer: str = "auto",
                        devices: int | None = None, block: int = 1024,
                        multicast: bool = True,
                        spatial_reduction: bool = True,
                        netspace: NetSpace | None = None,
                        max_states: int = 4096,
                        budget_policy: str = "uniform",
                        adapt_cover: float = 0.7,
                        build_kwargs: dict[str, Any] | None = None,
                        device: str | torch.device | None = None
                        ) -> NetSearchResult:
    """Search a whole-network schedule: per-layer mapping selection plus
    DeFiNES-style fused-stack segmentation.

    ``model`` is a zoo name (``"vgg16"``) or a list of layers; ``budget``
    caps evaluated mappings PER UNIQUE LAYER SHAPE (repeated shapes are
    deduplicated and broadcast).  ``strategy`` is ``auto`` /
    ``exhaustive`` / ``random`` — non-adaptive by design so every
    layer's frontier comes out of one device pass; for an explicit
    ``exhaustive``/``random`` strategy the candidate draws are identical
    to per-layer ``search()`` under the same seed (``auto`` differs:
    ``search()`` escalates oversized spaces to adaptive ``greedy``,
    netspace to ``random``).  With ``reconfig=False`` and ``fuse=False``
    the composed schedule's per-layer choices then provably coincide
    with independent per-layer searches at the same strategy/seed.  A caller-supplied ``hw`` is the reference design outright:
    its ``num_pes``/``noc_bw`` take precedence over the keyword defaults,
    and the reconfiguration/DRAM cost-model fields live on it.

    ``budget_policy="adaptive"`` spends a cheap uniform first pass
    (``budget // 4`` per unique shape), then steers the remaining budget
    toward the layers that dominate network cost: unique shapes are
    refined, by descending (multiplicity × best-value) contribution,
    until ``adapt_cover`` of the first-pass total is covered.  The
    refinement pass rides the already-warm family evaluators — zero
    extra warm-up passes.  Every device pass runs on ``device`` (``cuda``
    unless the caller asks for another)."""
    t0 = time.perf_counter()
    dev = resolve_device(device)
    eval_obj = _eval_objective(objective)
    if composer not in COMPOSERS:
        raise ValueError(f"composer must be one of {COMPOSERS}")
    if budget_policy not in BUDGET_POLICIES:
        raise ValueError(f"budget_policy must be one of "
                         f"{BUDGET_POLICIES}")
    layers = _layers_of(model)
    ns = netspace or build_netspace(layers, **(build_kwargs or {}))
    if hw is None:
        hw = HWConfig(num_pes=num_pes, noc_bw=noc_bw, noc_latency=2.0)
    # a caller-supplied HWConfig IS the reference design: its hardware
    # point wins over the num_pes/noc_bw keyword defaults
    num_pes, noc_bw = int(hw.num_pes), float(hw.noc_bw)

    cheap = budget if budget_policy == "uniform" \
        else max(16, budget // 4)
    cand: list[np.ndarray] = []
    strats_u: list[str] = []
    for u, op in enumerate(ns.unique):
        g, s = static_candidates(ns.spaces[u], strategy, cheap, seed)
        strats_u.append(s)               # auto may resolve per layer
        g = prune_genes_by_budget(op, ns.spaces[u], g,
                                  l1_kb=l1_prune_kb, l2_kb=l2_prune_kb)
        if not g.shape[0]:
            raise RuntimeError(f"{op.name}: budget pruning dropped every "
                               f"candidate")
        cand.append(g)
    strat = "+".join(dict.fromkeys(strats_u))

    ev_kw = dict(objective=eval_obj, num_pes=num_pes, noc_bw=noc_bw,
                 block=block, n_devices=devices, multicast=multicast,
                 spatial_reduction=spatial_reduction, device=dev)
    ev = evaluate_candidates(ns, cand, **ev_kw)
    vals = list(ev.vals)
    cols = list(ev.cols)

    refined: list[int] = []
    if budget_policy == "adaptive" and cheap < budget:
        extra, refined = _adaptive_refine(
            ns, cand, vals, cols, strats_u, budget=budget, cheap=cheap,
            seed=seed, l1_prune_kb=l1_prune_kb, l2_prune_kb=l2_prune_kb,
            adapt_cover=adapt_cover)
        if any(g.shape[0] for g in extra):
            ev2 = evaluate_candidates(ns, extra, **ev_kw)
            ev.run.merge(ev2.run)
            for u in refined:
                if extra[u].shape[0]:
                    cand[u] = np.concatenate([cand[u], extra[u]])
                    vals[u] = np.concatenate([vals[u], ev2.vals[u]])
                    cols[u] = np.concatenate([cols[u], ev2.cols[u]])

    fronts_u = [_frontier(ns, u, cand[u], vals[u], cols[u],
                          frontier_k) for u in range(len(ns.unique))]
    frontiers = [fronts_u[ns.index[i]] for i in range(ns.n_layers)]

    cost_model = NetCostModel(hw=hw, objective=eval_obj, fuse=fuse,
                              reconfig=reconfig,
                              l2_budget_kb=l2_budget_kb)
    names = [op.name for op in layers]
    macs = float(sum(op.total_macs for op in layers))
    t_c = time.perf_counter()
    with obs.span("compose", composer=composer, layers=ns.n_layers):
        if composer == "genetic":
            schedule, n_trans = compose_genetic(
                frontiers, _out_vols(layers), ns.fusible, cost_model,
                names, macs, seed=seed)
            used = "genetic"
        else:
            schedule, n_trans = compose_dp(
                frontiers, _out_vols(layers), ns.fusible, cost_model,
                names, macs, max_states=max_states)
            used = "dp"
    compose_s = time.perf_counter() - t_c
    obs.metrics().observe("netspace.compose_s", compose_s)
    obs.metrics().inc("netspace.transitions", n_trans)

    return NetSearchResult(
        objective=objective, strategy=strat, composer=used,
        schedule=schedule, netspace=ns, frontiers=fronts_u,
        model=cost_model,
        n_evaluated=int(sum(len(c) for c in cand)),
        n_layers=ns.n_layers, n_unique=len(ns.unique),
        n_classes=len(ns.classes), n_compiles=ev.run.n_compiles,
        compile_s=ev.run.compile_s, eval_s=ev.run.eval_s,
        encode_s=ev.run.encode_s, compose_s=compose_s,
        n_transitions=n_trans, elapsed_s=time.perf_counter() - t0,
        n_devices=ev.run.n_devices, budget_policy=budget_policy,
        refined=tuple(refined))


# ----------------------------------------------------------------------
# Uniform Table-3 baseline: the number the schedule must beat
# ----------------------------------------------------------------------

def uniform_baseline(layers: Sequence[LayerOp], model: NetCostModel,
                     flows: Sequence[str] = tuple(TABLE3)
                     ) -> dict[str, dict[str, float]]:
    """Each Table-3 dataflow applied network-wide (no fusion, and no
    reconfiguration by construction — one fixed mapping), accounted
    through the SAME cost model as searched schedules (off-chip boundary
    terms included when fusion modeling is on) so the comparison is
    apples to apples.  Shape-deduplicated: each distinct layer analyzed
    once."""
    unique, index = zoo.unique_layers(list(layers))
    out_vols = _out_vols(layers)
    out: dict[str, dict[str, float]] = {}
    for flow in flows:
        per_u = []
        for op in unique:
            s = analyze(op, table3_for_layer(flow, op), model.hw)
            per_u.append((float(s.runtime), float(s.energy_pj)))
        fr = []
        for i in range(len(layers)):
            r, e = per_u[index[i]]
            val = {"edp": e * r, "energy": e, "runtime": r}[
                model.objective]
            fr.append([CandStat(gene=(), val=val, runtime=r, energy=e,
                                l1_kb=0.0, l2_kb=0.0, halo=0.0,
                                struct=("t3", flow))])
        cost, energy, runtime = evaluate_schedule(
            fr, [0] * len(layers), [False] * (len(layers) - 1),
            out_vols, [False] * (len(layers) - 1), model)
        out[flow] = {"cost": cost, "energy_pj": energy,
                     "runtime": runtime, "edp": energy * runtime}
    return out


def best_uniform(baselines: dict[str, dict[str, float]],
                 key: str = "edp") -> tuple[str, dict[str, float]]:
    flow = min(baselines, key=lambda f: baselines[f][key])
    return flow, baselines[flow]


# ----------------------------------------------------------------------
# Network-level joint mapping x hardware co-DSE
# ----------------------------------------------------------------------

@dataclasses.dataclass
class CoNetResult:
    search: NetSearchResult
    pareto: list[dict[str, Any]]       # (energy, throughput) frontier
    best: dict[str, dict[str, Any] | None]
    top: list[dict[str, Any]]          # composer-refined best designs
    n_designs: int
    n_hw: int
    n_valid: int
    n_compiles: int
    elapsed_s: float


def co_search_network(model, cfg: DSEConfig | None = None,
                      objective: str = "edp", budget: int = 512,
                      **kwargs) -> CoNetResult:
    """Network-level joint co-DSE — the legacy entry point, a thin
    wrapper over the declarative session path (``repro_torch.api``);
    forwards verbatim to :func:`co_search_network_impl` (bit-equal by
    construction, see ``tests/test_torch_netspace.py``).  Runs on
    ``cuda`` unless ``device`` names another device."""
    from ..api.session import default_session
    return default_session().run_co_search_network(
        model, cfg=cfg, objective=objective, budget=budget, **kwargs)


def co_search_network_impl(model, cfg: DSEConfig | None = None,
                           objective: str = "edp", budget: int = 512, *,
                           num_pes: int = 256, noc_bw: float = 32.0,
                           seed: int = 0, frontier_k: int = 4,
                           refine_k: int = 4,
                           device: str | torch.device | None = None,
                           **search_kwargs) -> CoNetResult:
    """Network-level joint mapping × hardware sweep on ``device``
    (``cuda`` unless the caller asks for another): the reference
    ``search_network`` frontiers crossed with the full (PEs × bw) grid —
    hardware as per-row operands of the already-warm shape-as-operand
    evaluators (zero extra warm-up passes at matching block shapes) —
    under
    ``run_dse``-style accounting: SRAM provisioned for the worst layer,
    area/power budgets, leakage energy on the network runtime.

    Grid points use vectorized per-layer frontier selection; the
    ``refine_k`` best points are re-composed with the full fusion/
    reconfiguration DP before reporting."""
    t0 = time.perf_counter()
    dev = resolve_device(device)
    cfg = cfg or DSEConfig()
    eval_obj = _eval_objective(objective)
    ref = search_network_impl(model, objective=objective, budget=budget,
                              num_pes=num_pes, noc_bw=noc_bw, seed=seed,
                              frontier_k=frontier_k, device=dev,
                              **search_kwargs)
    ns = ref.netspace
    pes, bws = hw_grid(cfg)
    h = len(pes)
    macs = float(sum(op.total_macs for op in ns.layers))

    # frontier genes x hardware grid, per unique layer
    cand = []
    pes_rows, bw_rows = [], []
    f_sizes = []
    for u in range(len(ns.unique)):
        genes = np.asarray([c.gene for c in ref.frontiers[u]], np.int64)
        f_sizes.append(genes.shape[0])
        cand.append(np.repeat(genes, h, axis=0))
        pes_rows.append(np.tile(pes.astype(np.float32), genes.shape[0]))
        bw_rows.append(np.tile(bws, genes.shape[0]))
    ev = evaluate_candidates(
        ns, cand, objective=eval_obj, num_pes=pes_rows, noc_bw=bw_rows,
        dedupe=False, block=search_kwargs.get("block", 1024),
        n_devices=search_kwargs.get("devices"),
        multicast=search_kwargs.get("multicast", True),
        spatial_reduction=search_kwargs.get("spatial_reduction", True),
        device=dev)
    n_designs = int(sum(len(c) for c in cand))

    # vectorized per-layer selection per hardware point
    e_sum = np.zeros(h)
    r_sum = np.zeros(h)
    l1_max = np.zeros(h)
    l2_max = np.zeros(h)
    sel_per_u = []
    for u in range(len(ns.unique)):
        f = f_sizes[u]
        vals = ev.vals[u].reshape(f, h)
        cols = ev.cols[u].reshape(f, h, -1)
        sel = np.argmin(vals, axis=0)                   # (h,)
        sel_per_u.append(sel)
        picked = cols[sel, np.arange(h)]                # (h, 4)
        reps = sum(1 for i in ns.index if i == u)
        e_sum += reps * picked[:, 1]
        r_sum += reps * picked[:, 0]
        l1_max = np.maximum(l1_max, picked[:, 2])
        l2_max = np.maximum(l2_max, picked[:, 3])

    ap = cfg.area_power
    sram_kb = l1_max * pes + l2_max
    area = ap.area(pes, sram_kb, bws)
    power = ap.power(pes, sram_kb, bws)
    valid = (area <= cfg.area_budget_mm2) & (power <= cfg.power_budget_mw)
    energy = e_sum + ap.static_energy_pj(area, r_sum)
    thr = macs / np.maximum(r_sum, 1.0)
    edp = energy * r_sum
    obj_col = {"edp": edp, "energy": energy, "runtime": r_sum,
               "throughput": -thr}[objective]
    obj_col = np.where(valid, obj_col, np.inf)

    def design(i: int) -> dict[str, Any]:
        return {"num_pes": int(pes[i]), "noc_bw": float(bws[i]),
                "energy_pj": float(energy[i]), "runtime": float(r_sum[i]),
                "throughput": float(thr[i]), "edp": float(edp[i]),
                "area_mm2": float(area[i]), "power_mw": float(power[i])}

    # composer-refined top designs: re-run the fusion/reconfig DP at the
    # best grid points (per-layer selection is fusion-oblivious)
    top = []
    for i in np.argsort(obj_col, kind="stable")[:refine_k]:
        if not np.isfinite(obj_col[i]):
            break
        hw_i = ref.model.hw.replace(num_pes=int(pes[i]),
                                    noc_bw=float(bws[i]))
        fronts_u = []
        for u in range(len(ns.unique)):
            f = f_sizes[u]
            vals = ev.vals[u].reshape(f, h)[:, i]
            cols = ev.cols[u].reshape(f, h, -1)[:, i]
            genes = np.asarray([c.gene for c in ref.frontiers[u]],
                               np.int64)
            fronts_u.append(_frontier(ns, u, genes, vals, cols, f))
        frontiers = [fronts_u[ns.index[j]] for j in range(ns.n_layers)]
        model_i = dataclasses.replace(ref.model, hw=hw_i)
        with obs.span("compose", composer="dp-refine",
                      layers=ns.n_layers):
            sched, _ = compose_dp(frontiers, _out_vols(ns.layers),
                                  ns.fusible, model_i,
                                  [op.name for op in ns.layers], macs)
        d = design(int(i))
        d.update({"schedule_cost": sched.cost,
                  "schedule_energy_pj": sched.energy_pj
                  + float(ap.static_energy_pj(area[i], sched.runtime)),
                  "schedule_runtime": sched.runtime,
                  "n_reconfigs": sched.n_reconfigs,
                  "segments": sched.segments})
        top.append(d)

    front = pareto_front([design(i) for i in np.where(valid)[0]],
                         x="energy_pj", y="throughput")
    best: dict[str, dict[str, Any] | None] = {}
    for obj in ("throughput", "energy", "edp"):
        col = {"throughput": -thr, "energy": energy, "edp": edp}[obj]
        col = np.where(valid, col, np.inf)
        i = int(np.argmin(col))
        best[obj] = design(i) if np.isfinite(col[i]) else None

    return CoNetResult(
        search=ref, pareto=front, best=best, top=top,
        n_designs=n_designs + ref.n_evaluated, n_hw=h,
        n_valid=int(valid.sum()),
        n_compiles=ref.n_compiles + ev.run.n_compiles,
        elapsed_s=time.perf_counter() - t0)
