"""CLI for per-layer mapping search on PyTorch — the port of
``repro.launch.mapsearch``, over the port's declarative front door
(``repro_torch.api``).  It runs on ``cuda`` unless ``--device`` names
another device; there is no ``--jax-cache-dir`` (the port compiles
nothing).

Examples::

    # best EDP mapping for VGG16 conv13 at the Fig. 10 reference design
    PYTHONPATH=src python -m repro_torch.launch.mapsearch --model vgg16 \
        --layer 13

    # the same on the CPU
    PYTHONPATH=src python -m repro_torch.launch.mapsearch --model vgg16 \
        --layer 13 --device cpu

    # joint mapping x hardware co-DSE
    PYTHONPATH=src python -m repro_torch.launch.mapsearch --model resnet50 \
        --layer conv2 --objective edp --co-dse --budget 1500

    # list a model's layers
    PYTHONPATH=src python -m repro_torch.launch.mapsearch --model vgg16 \
        --list-layers

A multi-layer selection (``--layer all`` or a list) answers through
``Session.run_many``, which comes with the port's netspace (ROADMAP
queue 1, item 3); until then it raises ``NotImplementedError``, which
the CLI prints as one line and exits 2.
"""
from __future__ import annotations

import argparse

from ..api import Hardware, Query, SearchSpec, Workload, select_layers
from ..core import dnn_models as zoo
from ..core.dataflows import TABLE3, table3_for_layer
from ..core.model import analyze
from ..core.performance import HWConfig
from .query import (DEFAULT_CACHE, _fmt, add_obs_args, cli_errors,
                    obs_scope, print_layer_report, print_layer_codse_report,
                    session_from_args)


def _table3_values(op, args) -> tuple[float, dict[str, float]]:
    """(best value, per-flow value) of the Table 3 baselines at the CLI's
    hardware point and objective."""
    hw = HWConfig(num_pes=args.pes, noc_bw=args.bw, noc_latency=2.0)
    per_flow: dict[str, float] = {}
    best = None
    for f in TABLE3:
        st = analyze(op, table3_for_layer(f, op), hw)
        vals = {"edp": float(st.edp), "energy": float(st.energy_pj),
                "runtime": float(st.runtime),
                "throughput": float(st.throughput)}
        v = vals[args.objective]
        per_flow[f] = v
        if best is None or \
                (v > best if args.objective == "throughput" else v < best):
            best = v
    return best, per_flow


def _spec_from_args(args, op) -> SearchSpec:
    if args.quick:
        dims = tuple(args.dims.split(",")) if args.dims else \
            (("K", "C") if "K" in op.dims else None)
        cluster = False
        budget = min(args.budget, 200)
    else:
        dims = tuple(args.dims.split(",")) if args.dims else None
        cluster = not args.no_cluster
        budget = args.budget
    return SearchSpec(
        objective=args.objective, budget=budget, strategy=args.strategy,
        seed=args.seed, top_k=args.top_k, population=args.population,
        cluster=cluster, dims=dims, l1_prune_kb=args.l1_budget_kb,
        l2_prune_kb=args.l2_budget_kb, block=1024,
        pipeline=args.pipeline,
        codse_top_k=min(args.top_k, 4), joint_genes=args.joint_genes)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="vgg16",
                    choices=sorted(zoo.MODELS))
    ap.add_argument("--layer", default="0",
                    help="layer index or name substring (default: 0); "
                         "'all' and comma-separated lists need run_many, "
                         "not ported yet")
    ap.add_argument("--list-layers", action="store_true")
    ap.add_argument("--objective", default="edp",
                    choices=["edp", "energy", "runtime", "throughput"])
    ap.add_argument("--budget", type=int, default=1000,
                    help="max mappings to evaluate")
    ap.add_argument("--pes", type=int, default=256)
    ap.add_argument("--bw", type=float, default=32.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--strategy", default="auto",
                    choices=["auto", "exhaustive", "random", "greedy",
                             "genetic"])
    ap.add_argument("--top-k", type=int, default=5)
    ap.add_argument("--population", type=int, default=None,
                    help="genetic strategy population per generation")
    ap.add_argument("--dims", default=None,
                    help="comma-separated searched dims (default: auto)")
    ap.add_argument("--no-cluster", action="store_true",
                    help="exclude two-level (Cluster) mappings")
    ap.add_argument("--l1-budget-kb", type=float, default=None,
                    help="prune tile sets over this L1 budget")
    ap.add_argument("--l2-budget-kb", type=float, default=None,
                    help="prune tile sets over this L2 budget")
    ap.add_argument("--quick", action="store_true",
                    help="tiny space + budget (smoke test)")
    ap.add_argument("--pipeline", default="gene",
                    choices=["gene", "legacy"],
                    help="gene: vectorized gene-matrix pipeline "
                         "(default); legacy: tuple-point parity oracle "
                         "(never coalesced)")
    ap.add_argument("--devices", type=int, default=None,
                    help="CUDA devices to stripe evaluation chunks over "
                         "(default: all)")
    ap.add_argument("--device", default=None,
                    help="where to run (default cuda; 'cpu' on request)")
    ap.add_argument("--co-dse", action="store_true",
                    help="cross top-k mappings with the hardware DSE grid")
    ap.add_argument("--joint-genes", type=int, default=0,
                    help="with --co-dse: also run the paper-scale joint "
                         "sweep through the gene pipeline")
    ap.add_argument("--cache-dir", default=DEFAULT_CACHE,
                    help="on-disk result cache ('' disables)")
    add_obs_args(ap)
    args = ap.parse_args(argv)

    with cli_errors(), obs_scope(args):
        session = session_from_args(args)
        layers = zoo.MODELS[args.model]()
        if args.list_layers:
            for i, l in enumerate(layers):
                print(f"{i:3d} {l.op_type:10s} {l.name} {l.dims}")
            return
        try:
            picked = select_layers(layers, args.layer)
        except ValueError as e:
            raise SystemExit(f"{e}; try --list-layers")
        if len(picked) > 1:
            # the reference answers a selection as one coalesced batch
            raise NotImplementedError(
                f"Session.run_many (--layer {args.layer!r} selects "
                f"{len(picked)} layers) needs the port's netspace, not "
                "ported yet (ROADMAP queue 1, item 3)")
        op = picked[0]
        print(f"# layer {op.name} {op.op_type} {op.dims}")

        spec = _spec_from_args(args, op)
        hw = Hardware(num_pes=args.pes, noc_bw=args.bw)
        rep = session.run(Query(Workload.of_layer(op), hw, spec))
        print_layer_report(rep)

        # Table 3 baselines at the same hardware point
        print("\n# Table 3 baselines (same hardware):")
        best_t3, per_flow = _table3_values(op, args)
        for f, v in per_flow.items():
            print(f"  {f:5s} {args.objective}={_fmt(v)}")
        best_val = rep.best["value"]
        if args.objective == "throughput":
            imp = best_val / best_t3
        else:
            imp = best_t3 / best_val
        print(f"# best-found vs best-Table-3: {imp:.2f}x")

        if args.co_dse:
            grid = Hardware(
                num_pes=args.pes, noc_bw=args.bw,
                pe_range=tuple(range(32, 513, 32)),
                bw_range=tuple(float(b) for b in range(4, 65, 4)))
            co = session.run(Query(Workload.of_layer(op), grid, spec))
            print()
            print_layer_codse_report(co)


if __name__ == "__main__":
    main()
