"""The shared pieces of the declarative query CLI — the part of
``repro.launch.query`` that ``repro_torch.launch.mapsearch`` imports:
the logging and error brackets, the observability flags, the layer and
co-DSE report printers, and the constructors of a ``Session``,
``Hardware`` and ``SearchSpec`` from parsed flags.

The query CLI's own ``main`` (single queries from flags, ``--file``
batches through ``Session.run_many``) comes with the port's netspace and
serving tier (ROADMAP queue 1, items 3 and 5).  Every CLI here runs on
``cuda`` unless ``--device`` names another device.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import logging
import os
import sys
from typing import Any

from .. import obs
from ..api import Hardware, Report, SearchSpec, Session
from ..resilience import ReproError, ResilienceConfig

DEFAULT_CACHE = os.path.join(os.path.expanduser("~"), ".cache",
                             "repro_torch-mapspace")

# THE launch-CLI logger: every diagnostic/progress line routes through
# here (results still print to stdout); ``-v``/``-q`` pick the level in
# :func:`obs_scope`.
LOG = logging.getLogger("repro_torch.launch")


def _fmt(v: float) -> str:
    return f"{v:.4g}"


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
