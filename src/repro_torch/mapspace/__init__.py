"""Mapping-space search engine: auto-search over legal data-centric
directive programs, on PyTorch (the port of ``repro.mapspace``).

Evaluation runs through the *universal* structure-as-operand evaluator:
one evaluator per (op, level-count) whose operand columns encode the
entire mapping — tile sizes, loop permutation (rank vector), spatial
choice (one-hot), cluster option, and the hardware point.

Quick start::

    from repro_torch.core import tensor_analysis as ta
    from repro_torch.mapspace import search

    op = ta.conv2d("conv", k=128, c=64, y=32, x=32, r=3, s=3)
    result = search(op, objective="edp", budget=1000)   # on cuda
    result = search(op, objective="edp", budget=1000, device="cpu")
    print(result.best_dataflow)
    print(result.best_stats["edp"], result.mappings_per_s)

    # joint mapping x hardware co-DSE over the default (PEs x bw) grid
    co = co_search(op, objective="edp", mapping_budget=500, device="cpu")
    print(co.best["edp"], len(co.pareto))
"""
from .batched import EvalStats, evaluate_points, measure_rate
from .codse import (CoDSEResult, JointSweepResult, co_search,
                    co_search_impl, hw_grid, joint_sweep, merged_pareto)
from .search import (OBJECTIVES, PIPELINES, STRATEGIES, SearchResult,
                     search, search_impl, static_candidates)
from .space import (ClusterOption, GeneTables, MapSpace, MapSpaceError,
                    TileAxis, build_space, buffer_estimate_kb,
                    buffer_estimates_genes, canonical_signature,
                    decode_indices, dedupe_equivalent_genes,
                    dedupe_equivalent_points, enumerate_genes,
                    enumerate_points, flat_index, gene_tables,
                    genes_from_points, group_template, pad_tile_axes,
                    point_dataflow, points_from_genes, prune_by_budget,
                    prune_genes_by_budget, sample_genes, sample_points)
from .universal import (GeneEval, GeneRun, compile_count, encode_genes,
                        evaluate_genes, evaluate_points_universal,
                        universal_specs)

__all__ = [
    "ClusterOption", "CoDSEResult", "EvalStats", "GeneEval", "GeneRun",
    "GeneTables", "JointSweepResult", "MapSpace", "MapSpaceError",
    "OBJECTIVES", "PIPELINES", "STRATEGIES", "SearchResult", "TileAxis",
    "build_space", "buffer_estimate_kb", "buffer_estimates_genes",
    "canonical_signature", "co_search", "co_search_impl", "compile_count",
    "decode_indices", "dedupe_equivalent_genes",
    "dedupe_equivalent_points", "encode_genes", "enumerate_genes",
    "enumerate_points", "evaluate_genes", "evaluate_points",
    "evaluate_points_universal", "flat_index", "gene_tables",
    "genes_from_points", "group_template", "hw_grid", "joint_sweep",
    "measure_rate", "merged_pareto", "pad_tile_axes", "point_dataflow",
    "points_from_genes", "prune_by_budget", "prune_genes_by_budget",
    "sample_genes", "sample_points", "search", "search_impl",
    "static_candidates", "universal_specs",
]
