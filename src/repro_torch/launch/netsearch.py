"""CLI for whole-network schedule search on PyTorch — the port of
``repro.launch.netsearch``, over the port's declarative front door
(``repro_torch.api``).  It runs on ``cuda`` unless ``--device`` names
another device; there is no ``--jax-cache-dir`` (the port compiles
nothing).

Examples::

    # best-EDP VGG16 schedule (per-layer mappings + fused stacks) at the
    # Fig. 10 reference design
    PYTHONPATH=src python -m repro_torch.launch.netsearch --model vgg16

    # the same on the CPU
    PYTHONPATH=src python -m repro_torch.launch.netsearch --model vgg16 \
        --device cpu

    # ablations: no fusion / no reconfiguration cost
    PYTHONPATH=src python -m repro_torch.launch.netsearch --model vgg16 \
        --no-fuse --no-reconfig

    # network-level joint mapping x hardware co-DSE
    PYTHONPATH=src python -m repro_torch.launch.netsearch \
        --model resnet50 --co-dse --budget 256
"""
from __future__ import annotations

import argparse

from ..api import Hardware, Query, SearchSpec, Workload
from ..core import dnn_models as zoo
from ..netspace import best_uniform, uniform_baseline
from .query import (_fmt, add_obs_args, cli_errors, obs_scope,
                    print_network_codse_report, print_network_report,
                    session_from_args)


def network_queries(args) -> tuple[Query, Query | None]:
    """The CLI's network query and, with ``--co-dse``, its network co-DSE
    query (the 16 x 16 grid, or 3 x 3 with ``--quick``)."""
    budget = min(args.budget, 128) if args.quick else args.budget
    frontier_k = min(args.frontier_k, 4) if args.quick \
        else args.frontier_k
    hw_kw = dict(num_pes=args.pes, noc_bw=args.bw, dram_bw=args.dram_bw,
                 dram_energy_pj=args.dram_energy_pj,
                 reconfig_latency=args.reconfig_latency)
    spec = SearchSpec(objective=args.objective, budget=budget,
                      strategy=args.strategy, seed=args.seed,
                      frontier_k=frontier_k, fuse=not args.no_fuse,
                      reconfig=not args.no_reconfig,
                      l2_budget_kb=args.l2_budget_kb,
                      composer=args.composer,
                      budget_policy=args.budget_policy,
                      block=args.block, codse_top_k=4)
    query = Query(Workload.of_network(args.model), Hardware(**hw_kw), spec)
    if not args.co_dse:
        return query, None
    if args.quick:
        grid = Hardware(**hw_kw, pe_range=(64, 128, 256),
                        bw_range=(8.0, 16.0, 32.0))
    else:
        grid = Hardware(**hw_kw, pe_range=tuple(range(32, 513, 32)),
                        bw_range=tuple(float(b) for b in range(4, 65, 4)))
    co_spec = SearchSpec(
        objective=args.objective, budget=budget, strategy=args.strategy,
        seed=args.seed, frontier_k=min(frontier_k, 4),
        fuse=not args.no_fuse, reconfig=not args.no_reconfig,
        l2_budget_kb=args.l2_budget_kb, composer=args.composer,
        budget_policy=args.budget_policy, block=args.block)
    return query, Query(Workload.of_network(args.model), grid, co_spec)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="vgg16", choices=sorted(zoo.MODELS))
    ap.add_argument("--objective", default="edp",
                    choices=["edp", "energy", "runtime", "throughput"])
    ap.add_argument("--budget", type=int, default=512,
                    help="evaluated mappings per unique layer shape")
    ap.add_argument("--frontier-k", type=int, default=8,
                    help="per-layer frontier width the composer sees")
    ap.add_argument("--pes", type=int, default=256)
    ap.add_argument("--bw", type=float, default=32.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--strategy", default="auto",
                    choices=["auto", "exhaustive", "random"])
    ap.add_argument("--composer", default="auto",
                    choices=["auto", "dp", "genetic"])
    ap.add_argument("--budget-policy", default="uniform",
                    choices=["uniform", "adaptive"],
                    help="adaptive: cheap first pass, then refine the "
                         "top network-cost contributors (the query "
                         "CLI's default; uniform is this CLI's)")
    ap.add_argument("--no-fuse", action="store_true",
                    help="disable fused-stack/off-chip boundary modeling")
    ap.add_argument("--no-reconfig", action="store_true",
                    help="disable the mapping-switch reconfiguration cost")
    ap.add_argument("--l2-budget-kb", type=float, default=None,
                    help="fused-stack resident-tile L2 budget")
    ap.add_argument("--reconfig-latency", type=float, default=0.0,
                    help="fixed cycles per dataflow switch (HWConfig)")
    ap.add_argument("--dram-bw", type=float, default=16.0,
                    help="off-chip elements/cycle (HWConfig)")
    ap.add_argument("--dram-energy-pj", type=float, default=100.0,
                    help="pJ per off-chip element (HWConfig)")
    ap.add_argument("--devices", type=int, default=None,
                    help="CUDA devices to stripe evaluation over "
                         "(default: all)")
    ap.add_argument("--device", default=None,
                    help="where to run (default cuda; 'cpu' on request)")
    ap.add_argument("--block", type=int, default=1024)
    ap.add_argument("--co-dse", action="store_true",
                    help="cross the network frontiers with the hardware "
                         "DSE grid")
    ap.add_argument("--quick", action="store_true",
                    help="tiny budget/frontier (smoke test)")
    ap.add_argument("--cache-dir", default="",
                    help="on-disk result cache ('' disables)")
    add_obs_args(ap)
    return ap


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)

    with cli_errors(), obs_scope(args):
        session = session_from_args(args)
        query, co_query = network_queries(args)
        rep = session.run(query)
        print_network_report(rep)

        r = rep.raw
        base = uniform_baseline(r.netspace.layers, r.model)
        flow, b = best_uniform(base, "edp")
        print(f"\n# uniform Table-3 baselines (network EDP, same cost "
              f"model):")
        for f, v in base.items():
            mark = " <- best uniform" if f == flow else ""
            print(f"  {f:5s} EDP={_fmt(v['edp'])}{mark}")
        print(f"# schedule vs best uniform ({flow}): "
              f"{b['edp'] / r.schedule.network_edp:.2f}x better EDP")

        if co_query is not None:
            co = session.run(co_query)
            print()
            print_network_codse_report(co)


if __name__ == "__main__":
    main()
