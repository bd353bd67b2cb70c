"""Schedule composition: per-layer frontiers -> one network schedule —
the port of ``repro.netspace.composer`` (a numpy DP on the host).

The composer receives, per schedule position, a small frontier of
candidate mappings (value + runtime/energy/L1/L2 + fused-halo fraction)
and chooses (a) one candidate per layer and (b) a segmentation of the
layer chain into **fused stacks** (DeFiNES-style depth-first execution:
intermediate activations stay in L2 and never cross the off-chip
boundary).

Cost model (all terms additive over layers/boundaries, which is what
makes the DP exact):

  * node: the layer's objective value (EDP/energy/runtime as produced by
    the evaluator), adjusted by its incoming boundary's (Δe, Δr);
  * reconfiguration: when consecutive layers run DIFFERING mapping
    structures, the PE array drains the outgoing L1/L2 working set and
    refills the incoming one over the NoC plus a fixed latency
    (:func:`core.performance.reconfig_cycles`; new ``HWConfig`` fields);
  * un-fused boundary (fusion modeling on): the intermediate activation
    crosses off-chip twice — ``2·|O|`` elements at ``hw.dram_bw`` /
    ``hw.dram_energy_pj``;
  * fused boundary: no off-chip crossing; instead the producer re-runs
    the consumer's window-halo fraction (``space.halo_fractions`` —
    analytic sliding-overlap recompute), and the stack's L2 footprint
    accumulates: ``Σ l2_kb ≤ l2_budget_kb``.

``compose_dp`` runs exact dynamic programming over states
``(layer, candidate, resident-stack footprint)``; ``compose_genetic`` is
the fallback for schedules the chain DP cannot express (non-chain fusion
masks interact with beam limits) and shares the identical
:func:`evaluate_schedule` cost so the two composers are comparable.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np

from ..core.cluster_analysis import py_backend
from ..core.performance import HWConfig, dram_cycles, reconfig_cycles

_XP = py_backend()


@dataclasses.dataclass(frozen=True)
class CandStat:
    """One frontier candidate of one layer."""
    gene: tuple
    val: float           # canonical-minimize per-layer objective value
    runtime: float
    energy: float
    l1_kb: float
    l2_kb: float
    halo: float          # fused-consumer recompute fraction of producer
    struct: tuple        # reconfig identity: (class id, s, p, c)


@dataclasses.dataclass(frozen=True)
class NetCostModel:
    """Static knobs of the network cost model."""
    hw: HWConfig
    objective: str = "edp"         # edp | energy | runtime
    fuse: bool = True              # model the off-chip boundary + fusion
    reconfig: bool = True          # charge mapping-switch drain/refill
    l2_budget_kb: float | None = None


def edge_terms(prev: CandStat, nxt: CandStat, fused: bool,
               out_vol: float, model: NetCostModel
               ) -> tuple[float, float]:
    """(Δenergy pJ, Δruntime cycles) of the boundary entering ``nxt``."""
    hw = model.hw
    de = dr = 0.0
    if model.reconfig and prev.struct != nxt.struct:
        dr += float(reconfig_cycles(
            _XP, hw, l1_prev_kb=prev.l1_kb, l2_prev_kb=prev.l2_kb,
            l1_next_kb=nxt.l1_kb, l2_next_kb=nxt.l2_kb))
    if model.fuse:
        if fused:
            de += nxt.halo * prev.energy
            dr += nxt.halo * prev.runtime
        else:
            de += 2.0 * out_vol * hw.dram_energy_pj
            dr += float(dram_cycles(_XP, 2.0 * out_vol, hw))
    return de, dr


def node_cost(c: CandStat, de: float, dr: float, objective: str) -> float:
    """The layer's additive cost with its incoming boundary folded in.
    Expanded around the evaluator's own value so a zero boundary
    reproduces it EXACTLY (the reconfig-0/no-fusion parity guarantee)."""
    if objective == "edp":
        return c.val + c.energy * dr + de * c.runtime + de * dr
    if objective == "energy":
        return c.val + de
    return c.val + dr  # runtime (throughput canonicalizes to runtime)


@dataclasses.dataclass
class NetworkSchedule:
    """One whole-network schedule: per-layer mapping choice + fused-stack
    segmentation, with its cost-model accounting."""
    objective: str
    choice: list[int]              # frontier index per layer
    genes: list[tuple]             # chosen gene tuple per layer
    fuse: list[bool]               # per boundary: True = fused
    per_layer: list[dict[str, Any]]
    cost: float                    # additive objective incl. boundaries
    energy_pj: float
    runtime: float
    total_macs: float
    n_reconfigs: int

    @property
    def network_edp(self) -> float:
        return self.energy_pj * self.runtime

    @property
    def throughput(self) -> float:
        return self.total_macs / max(self.runtime, 1.0)

    @property
    def segments(self) -> list[tuple[int, int]]:
        """Fused stacks as inclusive (start, end) layer index ranges."""
        out = []
        start = 0
        for i, f in enumerate(self.fuse):
            if not f:
                out.append((start, i))
                start = i + 1
        out.append((start, len(self.choice) - 1))
        return out


def evaluate_schedule(frontiers: Sequence[Sequence[CandStat]],
                      choice: Sequence[int], fuse: Sequence[bool],
                      out_vols: Sequence[float],
                      fusible: Sequence[bool], model: NetCostModel
                      ) -> tuple[float, float, float]:
    """Cost-model accounting of one concrete schedule: ``(cost, energy,
    runtime)``; infeasible schedules (illegal fusion, fused stack over the
    L2 budget) cost ``inf``.  THE reference the DP and genetic composers
    — and the brute-force parity test — all share."""
    inf = (np.inf, np.inf, np.inf)
    cost = energy = runtime = 0.0
    stack_kb = 0.0
    for i, ci in enumerate(choice):
        c = frontiers[i][ci]
        de = dr = 0.0
        if i > 0:
            fused = bool(fuse[i - 1])
            if fused and not (model.fuse and fusible[i - 1]):
                return inf
            prev = frontiers[i - 1][choice[i - 1]]
            de, dr = edge_terms(prev, c, fused, out_vols[i - 1], model)
            stack_kb = stack_kb + c.l2_kb if fused else c.l2_kb
            if fused and model.l2_budget_kb is not None \
                    and stack_kb > model.l2_budget_kb:
                return inf
        else:
            stack_kb = c.l2_kb
        cost += node_cost(c, de, dr, model.objective)
        energy += c.energy + de
        runtime += c.runtime + dr
    return cost, energy, runtime


def _finalize(frontiers, choice, fuse, out_vols, fusible, model,
              layer_names, macs) -> NetworkSchedule:
    cost, energy, runtime = evaluate_schedule(
        frontiers, choice, fuse, out_vols, fusible, model)
    per_layer = []
    n_reconf = 0
    for i, ci in enumerate(choice):
        c = frontiers[i][ci]
        de = dr = 0.0
        if i > 0:
            prev = frontiers[i - 1][choice[i - 1]]
            de, dr = edge_terms(prev, c, bool(fuse[i - 1]),
                                out_vols[i - 1], model)
            n_reconf += int(prev.struct != c.struct)
        per_layer.append({
            "layer": layer_names[i], "gene": c.gene, "value": c.val,
            "runtime": c.runtime, "energy_pj": c.energy,
            "l1_kb": c.l1_kb, "l2_kb": c.l2_kb,
            "edge_energy_pj": de, "edge_cycles": dr})
    return NetworkSchedule(
        objective=model.objective, choice=list(choice),
        genes=[frontiers[i][ci].gene for i, ci in enumerate(choice)],
        fuse=[bool(f) for f in fuse], per_layer=per_layer, cost=cost,
        energy_pj=energy, runtime=runtime, total_macs=macs,
        n_reconfigs=n_reconf)


def compose_dp(frontiers: Sequence[Sequence[CandStat]],
               out_vols: Sequence[float], fusible: Sequence[bool],
               model: NetCostModel, layer_names: Sequence[str],
               macs: float, max_states: int = 4096
               ) -> tuple[NetworkSchedule, int]:
    """Exact DP over ``(layer, candidate, resident-stack footprint)``
    states (beam-capped at ``max_states`` per layer; exact whenever the
    cap is not hit, which the parity test relies on).  Returns the best
    schedule and the number of explored transitions."""
    L = len(frontiers)
    # state key (candidate, stack footprint) -> (cost, parent key, fused)
    cur: dict[tuple, tuple[float, tuple | None, bool]] = {}
    for ci, c in enumerate(frontiers[0]):
        key = (ci, round(c.l2_kb, 6))
        cost = node_cost(c, 0.0, 0.0, model.objective)
        if key not in cur or cost < cur[key][0]:
            cur[key] = (cost, None, False)
    parents: list[dict] = [dict(cur)]
    n_transitions = 0
    for b in range(L - 1):
        if len(cur) > max_states:
            keep = sorted(cur, key=lambda k: cur[k][0])[:max_states]
            cur = {k: cur[k] for k in keep}
            parents[b] = cur
        nxt: dict[tuple, tuple[float, tuple, bool]] = {}
        for key, (cost, _, _) in cur.items():
            ci, kb = key
            prev = frontiers[b][ci]
            for cj, c2 in enumerate(frontiers[b + 1]):
                for fused in (False, True):
                    if fused and not (model.fuse and fusible[b]):
                        continue
                    nkb = round(kb + c2.l2_kb, 6) if fused \
                        else round(c2.l2_kb, 6)
                    if fused and model.l2_budget_kb is not None \
                            and nkb > model.l2_budget_kb:
                        continue
                    n_transitions += 1
                    de, dr = edge_terms(prev, c2, fused, out_vols[b],
                                        model)
                    cost2 = cost + node_cost(c2, de, dr, model.objective)
                    k2 = (cj, nkb)
                    if k2 not in nxt or cost2 < nxt[k2][0]:
                        nxt[k2] = (cost2, key, fused)
        cur = nxt
        parents.append(cur)
    best_key = min(cur, key=lambda k: cur[k][0])
    choice = [0] * L
    fuse = [False] * max(L - 1, 0)
    key: tuple | None = best_key
    for i in range(L - 1, -1, -1):
        assert key is not None
        cost, parent, fused = parents[i][key]
        choice[i] = key[0]
        if i > 0:
            fuse[i - 1] = fused
        key = parent
    return (_finalize(frontiers, choice, fuse, out_vols, fusible, model,
                      layer_names, macs), n_transitions)


def compose_genetic(frontiers: Sequence[Sequence[CandStat]],
                    out_vols: Sequence[float], fusible: Sequence[bool],
                    model: NetCostModel, layer_names: Sequence[str],
                    macs: float, *, seed: int = 0, population: int = 64,
                    generations: int = 60, mutate_p: float = 0.15,
                    tournament: int = 3) -> tuple[NetworkSchedule, int]:
    """Genetic fallback over (per-layer choice, boundary fuse bits) for
    schedules outside the chain DP's reach (non-chain fusion masks /
    beam-capped state spaces).  Same :func:`evaluate_schedule` cost as
    the DP; deterministic under ``seed``."""
    rng = np.random.default_rng(seed)
    L = len(frontiers)
    nc = np.asarray([len(f) for f in frontiers])
    nb = max(L - 1, 0)

    def fitness(ch, fb) -> float:
        return evaluate_schedule(frontiers, ch, fb, out_vols, fusible,
                                 model)[0]

    pop_c = rng.integers(0, nc[None, :], size=(population, L))
    pop_f = rng.integers(0, 2, size=(population, nb)).astype(bool)
    pop_c[0] = 0                     # seed the per-layer-best schedule
    pop_f[0] = False
    fit = np.asarray([fitness(pop_c[i], pop_f[i])
                      for i in range(population)])
    n_evals = population
    for _ in range(generations):
        order = np.argsort(fit, kind="stable")
        pop_c, pop_f, fit = pop_c[order], pop_f[order], fit[order]
        ia = rng.integers(0, population, (population, tournament)).min(1)
        ib = rng.integers(0, population, (population, tournament)).min(1)
        mc = rng.random((population, L))
        mf = rng.random((population, nb))
        child_c = np.where(mc < mutate_p,
                           rng.integers(0, nc[None, :],
                                        (population, L)),
                           np.where(mc < (1 + mutate_p) / 2,
                                    pop_c[ia], pop_c[ib]))
        child_f = np.where(mf < mutate_p,
                           rng.integers(0, 2, (population, nb)) > 0,
                           np.where(mf < (1 + mutate_p) / 2,
                                    pop_f[ia], pop_f[ib]))
        child_fit = np.asarray([fitness(child_c[i], child_f[i])
                                for i in range(population)])
        n_evals += population
        both_c = np.concatenate([pop_c, child_c])
        both_f = np.concatenate([pop_f, child_f])
        both = np.concatenate([fit, child_fit])
        keep = np.argsort(both, kind="stable")[:population]
        pop_c, pop_f, fit = both_c[keep], both_f[keep], both[keep]
    best = int(np.argmin(fit))
    return (_finalize(frontiers, pop_c[best].tolist(),
                      pop_f[best].tolist(), out_vols, fusible, model,
                      layer_names, macs), n_evals)
