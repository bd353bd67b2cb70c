"""The declarative query CLI — one front door for every search engine, on
PyTorch (the port of ``repro.launch.query``).  It runs on ``cuda`` unless
``--device`` names another device; there is no ``--jax-cache-dir`` (the
port compiles nothing).

Single queries come from flags; batches come from ``--file queries.json``
(a JSON list of query dicts) and are answered through
``Session.run_many`` — heterogeneous single-layer queries that share an
(op-class, level-count) family coalesce into one padded device pass.

Examples::

    # best-EDP mapping for one layer at the Fig. 10 reference design
    PYTHONPATH=src python -m repro_torch.launch.query --model vgg16 \
        --layer 12

    # whole-network schedule search (the netsearch path), on the CPU
    PYTHONPATH=src python -m repro_torch.launch.query --model vgg16 \
        --device cpu

    # joint mapping x hardware co-DSE over the default grid
    PYTHONPATH=src python -m repro_torch.launch.query --model vgg16 \
        --layer 12 --co-dse

    # serving-style batch: mixed layer/network/grid queries, coalesced
    PYTHONPATH=src python -m repro_torch.launch.query \
        --file examples/queries.json --out reports.json

``repro_torch.launch.mapsearch`` and ``repro_torch.launch.netsearch`` are
CLIs over the same backend.  (The reference's ``--profile-dir`` and
``--flight-dir`` come with the port's profiler hook and flight recorder,
ROADMAP queue 1, item 4.)
"""
from __future__ import annotations

import argparse
import contextlib
import json
import logging
import os
import sys
from typing import Any, Sequence

from .. import obs
from ..api import (Hardware, Query, Report, SearchSpec, Session, Workload,
                   queries_from_file)
from ..core import dnn_models as zoo
from ..resilience import ReproError, ResilienceConfig

DEFAULT_CACHE = os.path.join(os.path.expanduser("~"), ".cache",
                             "repro_torch-mapspace")

# THE launch-CLI logger: every diagnostic/progress line routes through
# here (results still print to stdout); ``-v``/``-q`` pick the level in
# :func:`obs_scope`.
LOG = logging.getLogger("repro_torch.launch")


def _fmt(v: float) -> str:
    return f"{v:.4g}"


def _write_json(path: str, payload: Any) -> None:
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(payload, f, indent=2)
    LOG.info("wrote %s", path)


def configure_logging(args) -> None:
    """One logging config for every launch CLI: ``-v`` -> DEBUG,
    default INFO, ``-q`` -> WARNING (diagnostics go to stderr; result
    tables stay on stdout)."""
    level = logging.INFO
    if getattr(args, "quiet", 0):
        level = logging.WARNING
    if getattr(args, "verbose", 0):
        level = logging.DEBUG
    logging.basicConfig(level=level, stream=sys.stderr,
                        format="# %(message)s")
    logging.getLogger("repro_torch").setLevel(level)


@contextlib.contextmanager
def cli_errors():
    """CLI-facing slice of the resilience error taxonomy: a
    :class:`ReproError` escaping a launch entry point prints as ONE line
    on stderr and exits 2, and so does a path the port does not have yet
    (``NotImplementedError``, which names its ROADMAP item)."""
    try:
        yield
    except ReproError as e:
        print(f"error: {e.one_line()}", file=sys.stderr)
        raise SystemExit(2) from e
    except NotImplementedError as e:
        print(f"error: {e}", file=sys.stderr)
        raise SystemExit(2) from e


@contextlib.contextmanager
def obs_scope(args):
    """Observability bracket around one CLI run: configures logging,
    turns on the span tracer for ``--trace``, and on exit writes the
    trace file and prints the metrics snapshot for ``--metrics``.  (The
    reference's ``--profile-dir`` and ``--flight-dir`` come with the
    port's profiler hook and flight recorder, ROADMAP queue 1, item 4.)"""
    configure_logging(args)
    if getattr(args, "trace", None):
        obs.enable_tracing()
    try:
        yield
    finally:
        if getattr(args, "trace", None):
            obs.save_trace(args.trace)
            LOG.info("wrote trace %s", args.trace)
        if getattr(args, "metrics", False):
            print(json.dumps(obs.metrics().snapshot(), indent=2))


# ----------------------------------------------------------------------
# Report printers
# ----------------------------------------------------------------------

def print_layer_report(rep: Report) -> None:
    r = rep.raw
    tag = ""
    if r is not None and getattr(r, "cached", False):
        tag = " (cached)"
    via = "coalesced family pass" if rep.coalesced else \
        f"strategy={rep.strategy}"
    print(f"# {rep.name}: {via}{tag} evaluated={rep.n_evaluated} "
          f"compiles={rep.n_compiles} ({rep.compile_s:.1f}s) "
          f"devices={rep.n_devices}")
    if rep.rates.get("end_to_end_mappings_per_s"):
        print(f"# rate={rep.rates['mappings_per_s'] / 1e6:.2f}M "
              f"mappings/s "
              f"e2e={rep.rates['end_to_end_mappings_per_s'] / 1e6:.2f}M "
              f"mappings/s")
    print(f"best {rep.objective} = {_fmt(rep.best['value'])}  "
          f"gene={'-'.join(str(g) for g in rep.best['point'])}")
    if r is not None and hasattr(r, "best_dataflow"):
        print(r.best_dataflow)
    s = rep.best["stats"]
    print(f"runtime={_fmt(s['runtime'])}cy "
          f"energy={_fmt(s['energy_pj'])}pJ "
          f"l1={_fmt(s['l1_kb'])}KB l2={_fmt(s['l2_kb'])}KB")


def print_network_report(rep: Report) -> None:
    b = rep.best
    print(f"# {rep.name}: {rep.extras['n_layers']} layers "
          f"({rep.extras['n_unique']} unique shapes, "
          f"{rep.extras['n_classes']} op-classes) "
          f"strategy={rep.strategy} composer={rep.extras['composer']} "
          f"budget_policy={rep.extras['budget_policy']}")
    print(f"# evaluated={rep.n_evaluated} mappings, "
          f"compiles={rep.n_compiles} ({rep.compile_s:.1f}s), "
          f"eval={rep.eval_s:.2f}s, wall={rep.elapsed_s:.1f}s, "
          f"devices={rep.n_devices}")
    seg_of = {}
    for si, (a, bnd) in enumerate(b["segments"]):
        for i in range(a, bnd + 1):
            seg_of[i] = si
    print(f"\n{'layer':28s} {'seg':>4s} {'runtime':>12s} "
          f"{'energy':>12s} {'l2KB':>8s}  mapping")
    for i, pl in enumerate(b["per_layer"]):
        gene = "-".join(str(g) for g in pl["gene"])
        print(f"{pl['layer']:28s} {seg_of[i]:>4d} "
              f"{_fmt(pl['runtime']):>12s} "
              f"{_fmt(pl['energy_pj']):>12s} "
              f"{pl['l2_kb']:>8.1f}  {gene}")
    print(f"\n# schedule: {len(b['segments'])} fused stacks, "
          f"{b['n_reconfigs']} reconfigurations")
    print(f"# totals: runtime={_fmt(b['runtime'])}cy "
          f"energy={_fmt(b['energy_pj'])}pJ EDP={_fmt(b['edp'])} "
          f"throughput={b['throughput']:.2f} MACs/cy")


def _print_pareto(rep: Report, limit: int = 12) -> None:
    print(f"# frontier ({len(rep.pareto)} points, energy vs throughput):")
    for p in rep.pareto[:limit]:
        extra = f" {p['mapping']:24s}" if "mapping" in p else ""
        print(f"  pes={p['num_pes']:4d} bw={p['noc_bw']:5.1f} "
              f"energy={_fmt(p['energy_pj'])} "
              f"thr={_fmt(p['throughput'])}{extra}")
    for obj, p in rep.best["per_objective"].items():
        if p:
            print(f"  best {obj:10s}: pes={p['num_pes']} "
                  f"bw={p['noc_bw']}")


def print_layer_codse_report(rep: Report) -> None:
    print(f"# {rep.name}: co-DSE, {rep.n_evaluated} designs in "
          f"{rep.elapsed_s:.1f}s, compiles={rep.n_compiles}")
    if "joint" in rep.extras:
        j = rep.extras["joint"]
        print(f"# joint sweep: {j['n_designs']} designs "
              f"({j['n_valid']} valid) at "
              f"{j['designs_per_s'] / 1e6:.2f}M designs/s")
    _print_pareto(rep)


def print_network_codse_report(rep: Report) -> None:
    print(f"# {rep.name}: network co-DSE over "
          f"{rep.extras['n_hw']} hw points, {rep.n_evaluated} designs "
          f"in {rep.elapsed_s:.1f}s; {rep.extras['n_valid']} valid, "
          f"compiles={rep.n_compiles}")
    _print_pareto(rep)


def print_error_report(rep: Report) -> None:
    e = rep.extras["error"]
    print(f"# {rep.name or '(query)'}: FAILED — "
          f"{e['type']}: {e['message']}")


def print_timeout_report(rep: Report) -> None:
    t = rep.extras["timeout"]
    budget = "server default" if t["deadline_s"] is None else \
        f"{t['deadline_s']}s"
    print(f"# {rep.name or '(query)'}: TIMEOUT — deadline {budget} "
          f"expired after {t['waited_s']}s ({t['where']}); "
          f"partial answer only")


PRINTERS = {
    "layer": print_layer_report,
    "layer_codse": print_layer_codse_report,
    "network": print_network_report,
    "network_codse": print_network_codse_report,
    "error": print_error_report,
    "timeout": print_timeout_report,
}


def print_report(rep: Report) -> None:
    PRINTERS[rep.kind](rep)


def print_layer_table(reps: Sequence[Report], objective: str) -> None:
    """Per-layer best-mapping table (``mapsearch --layer all``)."""
    print(f"{'layer':28s} {'eval':>6s} {'best ' + objective:>14s}  "
          f"mapping")
    for rep in reps:
        gene = "-".join(str(g) for g in rep.best["point"])
        print(f"{rep.name:28s} {rep.n_evaluated:>6d} "
              f"{_fmt(rep.best['value']):>14s}  {gene}")


def print_batch_summary(session: Session) -> None:
    b = session.last_batch
    if not b:
        return
    print(f"\n# batch: {b['n_queries']} queries "
          f"({b['n_coalesced']} coalesced into {b['n_families']} "
          f"family passes), compiles={b['n_compiles']}"
          f"/{b['compile_budget']} budget ({b['compile_s']:.1f}s), "
          f"wall={b['elapsed_s']:.1f}s, devices={b['n_devices']}")


# ----------------------------------------------------------------------
# Query construction from flags
# ----------------------------------------------------------------------

def session_from_args(args) -> Session:
    res = None
    ckpt_dir = getattr(args, "checkpoint_dir", None)
    faults = getattr(args, "faults", None)
    if ckpt_dir or faults:
        res = ResilienceConfig(ckpt_dir=ckpt_dir or None,
                               faults=faults or None)
    return Session(cache_dir=(args.cache_dir or None),
                   devices=args.devices, resilience=res,
                   device=args.device)


def hardware_from_args(args) -> Hardware:
    kw: dict[str, Any] = dict(num_pes=args.pes, noc_bw=args.bw)
    for name in ("reconfig_latency", "dram_bw", "dram_energy_pj"):
        if getattr(args, name, None) is not None:
            kw[name] = getattr(args, name)
    if getattr(args, "co_dse", False):
        if args.quick:
            kw["pe_range"] = (64, 128, 256)
            kw["bw_range"] = (8.0, 16.0, 32.0)
        else:
            kw["pe_range"] = tuple(range(32, 513, 32))
            kw["bw_range"] = tuple(float(b) for b in range(4, 65, 4))
    return Hardware(**kw)


def searchspec_from_args(args, *, dims=None, cluster=True) -> SearchSpec:
    budget = args.budget
    frontier_k = getattr(args, "frontier_k", 8)
    if args.quick:
        budget = min(budget, 128)
        frontier_k = min(frontier_k, 4)
    return SearchSpec(
        objective=args.objective, budget=budget,
        strategy=args.strategy, seed=args.seed, top_k=args.top_k,
        frontier_k=frontier_k,
        fuse=not getattr(args, "no_fuse", False),
        reconfig=not getattr(args, "no_reconfig", False),
        composer=getattr(args, "composer", "auto"),
        l2_budget_kb=getattr(args, "l2_budget_kb", None),
        budget_policy=getattr(args, "budget_policy", "adaptive"),
        cluster=cluster, dims=dims,
        l1_prune_kb=getattr(args, "l1_budget_kb", None),
        l2_prune_kb=getattr(args, "l2_prune_kb", None),
        population=getattr(args, "population", None),
        block=args.block,
        pipeline=getattr(args, "pipeline", "gene"),
        codse_top_k=min(args.top_k, 4),
        joint_genes=getattr(args, "joint_genes", 0))


def add_common_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--objective", default="edp",
                    choices=["edp", "energy", "runtime", "throughput"])
    ap.add_argument("--budget", type=int, default=512,
                    help="evaluated mappings (per unique layer shape for "
                         "network queries)")
    ap.add_argument("--pes", type=int, default=256)
    ap.add_argument("--bw", type=float, default=32.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--top-k", type=int, default=5)
    ap.add_argument("--block", type=int, default=1024)
    ap.add_argument("--devices", type=int, default=None,
                    help="CUDA devices to stripe evaluation over "
                         "(default: all)")
    ap.add_argument("--device", default=None,
                    help="where to run (default cuda; 'cpu' on request)")
    ap.add_argument("--quick", action="store_true",
                    help="tiny budgets (smoke test)")
    ap.add_argument("--cache-dir", default=DEFAULT_CACHE,
                    help="on-disk result cache ('' disables)")
    ap.add_argument("--checkpoint-dir", default=None, metavar="DIR",
                    help="sweep checkpoint directory: a killed run "
                         "re-launched with the same flags resumes "
                         "bit-identically from the last chunk")
    ap.add_argument("--faults", default=None, metavar="SPEC",
                    help="deterministic fault injection, e.g. "
                         "'kill@chunk:3' (see repro_torch.resilience."
                         "faultinject)")
    add_obs_args(ap)


def add_obs_args(ap: argparse.ArgumentParser) -> None:
    """The shared observability flags: logging verbosity, span tracing,
    metrics snapshot."""
    ap.add_argument("-v", "--verbose", action="count", default=0,
                    help="debug logging")
    ap.add_argument("-q", "--quiet", action="count", default=0,
                    help="warnings only")
    ap.add_argument("--trace", default=None, metavar="FILE",
                    help="record a Chrome/Perfetto trace_event timeline "
                         "of the run (open in ui.perfetto.dev)")
    ap.add_argument("--metrics", action="store_true",
                    help="print the obs metrics snapshot (JSON) at exit")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--file", default=None,
                    help="JSON batch of queries (list of query dicts or "
                         "{'queries': [...]}); answered via "
                         "Session.run_many with family coalescing")
    ap.add_argument("--out", default=None,
                    help="write reports (+ batch stats) as JSON")
    ap.add_argument("--no-coalesce", action="store_true",
                    help="batch mode: run each query separately through "
                         "the same family spaces (determinism oracle)")
    ap.add_argument("--model", default=None, choices=sorted(zoo.MODELS))
    ap.add_argument("--layer", default=None,
                    help="layer selector (index/substring/'all'/comma "
                         "list); omit for a whole-network query")
    ap.add_argument("--list-layers", action="store_true")
    ap.add_argument("--strategy", default="auto",
                    choices=["auto", "exhaustive", "random", "greedy",
                             "genetic"])
    ap.add_argument("--frontier-k", type=int, default=8)
    ap.add_argument("--budget-policy", default="adaptive",
                    choices=["adaptive", "uniform"],
                    help="network queries: adaptive refines the top "
                         "network-cost contributors")
    ap.add_argument("--composer", default="auto",
                    choices=["auto", "dp", "genetic"])
    ap.add_argument("--no-fuse", action="store_true")
    ap.add_argument("--no-reconfig", action="store_true")
    ap.add_argument("--l2-budget-kb", type=float, default=None)
    ap.add_argument("--co-dse", action="store_true",
                    help="sweep the hardware grid (joint co-DSE)")
    ap.add_argument("--joint-genes", type=int, default=0)
    add_common_args(ap)
    args = ap.parse_args(argv)

    with cli_errors(), obs_scope(args):
        session = session_from_args(args)

        if args.file:
            # the batch execution path of the serving tier
            # (serve.coalescer.execute_batch): --file batches are the
            # offline oracle a coalesced server answers bit-equal to
            from ..serve import execute_batch
            queries = queries_from_file(args.file)
            reports = execute_batch(session, queries,
                                    coalesce=not args.no_coalesce)
            for i, rep in enumerate(reports):
                tag = f" [{rep.tag}]" if rep.tag else ""
                print(f"\n=== query {i}{tag}: {rep.kind} {rep.name} ===")
                print_report(rep)
            print_batch_summary(session)
            if args.out:
                payload = {"reports": [r.to_json() for r in reports],
                           "batch": session.last_batch,
                           "metrics": session.metrics(),
                           "environment": obs.environment(
                               session.device)}
                _write_json(args.out, payload)
            return

        if not args.model:
            ap.error("give --model (single query) or --file (batch)")
        layers = zoo.MODELS[args.model]()
        if args.list_layers:
            for i, l in enumerate(layers):
                print(f"{i:3d} {l.op_type:10s} {l.name} {l.dims}")
            return

        from ..api import select_layers
        hw = hardware_from_args(args)
        spec = searchspec_from_args(args)
        if args.layer is None:
            rep = session.run(Query(Workload.of_network(args.model), hw,
                                    spec))
            print_report(rep)
            out_payload: Any = rep.to_json()
        elif len(select_layers(layers, args.layer)) == 1:
            rep = session.run(Query(
                Workload(model=args.model, layer=args.layer), hw, spec))
            print_report(rep)
            out_payload = rep.to_json()
        else:
            if args.co_dse:
                LOG.warning("--co-dse applies to single-layer selections "
                            "only; running the per-layer batch instead")
                hw = Hardware(num_pes=args.pes, noc_bw=args.bw)
            qs = [Query(Workload.of_layer(op), hw, spec)
                  for op in select_layers(layers, args.layer)]
            reps = session.run_many(qs)
            print_layer_table(reps, args.objective)
            print_batch_summary(session)
            out_payload = {"reports": [r.to_json() for r in reps],
                           "batch": session.last_batch,
                           "metrics": session.metrics()}
        if args.out:
            _write_json(args.out, out_payload)


if __name__ == "__main__":
    main()
