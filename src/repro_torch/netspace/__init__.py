"""Whole-network, fusion-aware schedule search on the gene pipeline — the
port of ``repro.netspace``, on PyTorch.

MAESTRO's headline DSE (paper §VII) optimizes one layer at a time, but the
paper's own Fig. 11 shows the optimal dataflow flips across layer shapes
within one network.  ``repro_torch.netspace`` searches schedules for the
ENTIRE network:

  * :func:`build_netspace` — op-class grouping with a SHARED gene layout
    per class (padded per-layer spaces, identical ``gene_ranges()``);
  * the batched evaluator — layer shape is an additional operand column
    of the universal evaluator, so one evaluator per (op-class,
    level-count) produces every layer's candidate frontier in a single
    device pass over a ``(n_layers, n_candidates, G)`` gene tensor;
  * the DP composer — per-layer mapping selection + DeFiNES-style fused
    layer stacks (intermediate activations resident in L2, analytic
    halo/recompute overhead) under an explicit reconfiguration-cost model
    (L1/L2 drain/refill between differing mappings, ``HWConfig``
    fields), with a genetic fallback for non-chain fusion masks;
  * :func:`search_network` / :func:`co_search_network` — the end-to-end
    APIs, the latter crossing network frontiers with the hardware grid
    under ``run_dse``-style area/power/leakage accounting.

Every device pass runs on ``cuda`` unless the caller names another device.
Quick start::

    from repro_torch.netspace import search_network

    r = search_network("vgg16", objective="edp", budget=512)
    r = search_network("vgg16", objective="edp", budget=512,
                       device="cpu")
    print(r.schedule.segments, r.schedule.network_edp)

See ``repro_torch.launch.netsearch`` for the CLI.
"""
from .composer import (CandStat, NetCostModel, NetworkSchedule,
                       compose_dp, compose_genetic, edge_terms,
                       evaluate_schedule, node_cost)
from .evaluator import COLS, NetEval, evaluate_candidates, evaluate_rows
from .search import (BUDGET_POLICIES, CoNetResult, NetSearchResult,
                     best_uniform, co_search_network,
                     co_search_network_impl, search_network,
                     search_network_impl, uniform_baseline)
from .space import (NetClass, NetSpace, build_netspace, halo_fractions)

__all__ = [
    "BUDGET_POLICIES", "COLS", "CandStat", "CoNetResult", "NetClass",
    "NetCostModel", "NetEval", "NetSearchResult", "NetworkSchedule",
    "best_uniform", "build_netspace", "co_search_network",
    "co_search_network_impl", "compose_dp", "compose_genetic",
    "edge_terms", "evaluate_candidates", "evaluate_rows",
    "evaluate_schedule", "halo_fractions", "node_cost", "search_network",
    "search_network_impl", "uniform_baseline",
]
