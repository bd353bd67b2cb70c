#!/usr/bin/env python3
"""Write the JAX package's front-door reports that the PyTorch port is held
against: ``tests/data/torch_front_door_fixture.json`` and, with ``--set
netsearch``, ``tests/data/torch_netsearch_fixture.json``.

    PYTHONPATH=src python3 scripts/make_front_door_fixture.py [--out PATH]
        [--cases NAME ...]
    PYTHONPATH=src python3 scripts/make_front_door_fixture.py \\
        --set netsearch [--out PATH] [--cases NAME ...]
    PYTHONPATH=src python3 scripts/make_front_door_fixture.py \\
        --set serve [--out PATH]
    PYTHONPATH=src python3 scripts/make_front_door_fixture.py \\
        --queries QUERIES.json [--batch] --out REPORTS.json

Each case is one ``repro.api.Session(cache_dir=None).run(query)`` call on
vgg16-conv13 (K=C=512, 14x14 outputs, 3x3): ``layer``, a mapping search of
the session's default space (pes 256, bw 32, EDP, budget 600, block 1024,
top-k 8), and ``layer_codse``, the joint co-DSE of
``benchmarks/run.py::bench_mapspace`` at the default 128 x 128
``DSEConfig`` grid (codse top-k 4, 32 joint genes).  The file keeps each
query's JSON, its fingerprint and its report's JSON without the fields
that time the run (``VOLATILE``).  ``chip_smoke.py::phase_front_door``
and ``tests/test_torch_api.py`` read it back and hold the port's reports
to it with ``compare`` (points identical, values at rtol 1e-6, top-k
swaps only within 1e-6 ties).

The ``netsearch`` set holds vgg16 at full width and depth (16 layers, 12
unique shapes, 2 op-classes) through three workloads, each at its CLI's
defaults: ``network``, the query of ``launch/netsearch.py --model vgg16``
(pes 256, bw 32, EDP, budget 512 per unique shape, uniform, frontier_k 8,
fuse and reconfig on, block 1024); ``network_codse``, the second query of
``netsearch --model vgg16 --co-dse`` (the 16 x 16 grid, pes 32..512 step
32, bw 4..64 step 4, frontier_k 4); and ``run_many``, the batch of
``launch/mapsearch.py --model vgg16 --layer all`` (16 layer queries,
budget 1000, top-k 5, pes 256, bw 32, EDP), answered coalesced by
``Session.run_many``.  ``chip_smoke.py::phase_netsearch`` and
``tests/test_torch_netspace.py`` read it back.

The ``serve`` set (``tests/data/torch_serve_fixture.json``) holds one
case, ``serve``: the three small conv queries of ``tests/test_serve.py``
(``QUERIES``: budget 32, block 64, top-k 4, pes 48, bw 12; objectives
edp, runtime and energy) answered as ONE batch by the reference's
``repro.serve.execute_batch``, the path a server's flush takes.
``tests/test_torch_serve.py`` holds the port's single flush of the same
three queries to it.

``--queries`` runs a JSON list of query dicts instead and writes their
reports as a JSON list (the CPU tests hold the port's session to the
reference this way); with ``--batch`` the list is answered as one
``Session.run_many`` batch, as ``launch/query.py --file`` answers it.

The reference runs on the CPU with XLA's CPU code generation capped at
AVX (``--xla_cpu_max_isa=AVX``, set here before JAX loads), as
``scripts/make_mapsearch_fixture.py`` does and for the same reason: on
a host with FMA, XLA contracts ``a * b + c`` into fused multiply-adds,
and the results would depend on the host's CPU.  Cases run in processes
of their own, side by side.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import json
import math
import multiprocessing
import os
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "tests" / "data" / "torch_front_door_fixture.json"
ISA_FLAG = "--xla_cpu_max_isa=AVX"
RTOL = 1e-6

# "default" stands for the package's DSEConfig() grid (128 x 128)
CASES = {
    "layer": {
        "workload": {"model": "vgg16", "layer": "conv13"},
        "hardware": {"num_pes": 256, "noc_bw": 32.0},
        "search": {"objective": "edp", "budget": 600, "block": 1024,
                   "top_k": 8}},
    "layer_codse": {
        "workload": {"model": "vgg16", "layer": "conv13"},
        "hardware": {"num_pes": 256, "noc_bw": 32.0,
                     "pe_range": "default", "bw_range": "default"},
        "search": {"objective": "edp", "budget": 600, "codse_top_k": 4,
                   "joint_genes": 32, "block": 1024}},
}

# the vgg16 network workloads (``--set netsearch``): the netsearch CLI's
# defaults, written out in full as the CLI's ``Query.describe()`` gives
# them, and the mapsearch CLI's ``--layer all`` batch, built per layer by
# ``layer_batch``
_NET_HW = {"num_pes": 256, "noc_bw": 32.0, "reconfig_latency": 0.0,
           "dram_bw": 16.0, "dram_energy_pj": 100.0}
_NET_SEARCH = {"objective": "edp", "budget": 512, "strategy": "auto",
               "seed": 0, "top_k": 8, "frontier_k": 8, "fuse": True,
               "reconfig": True, "composer": "auto",
               "budget_policy": "uniform", "cluster": True, "block": 1024,
               "pipeline": "gene", "multicast": True,
               "spatial_reduction": True, "codse_top_k": 4,
               "joint_genes": 0}
NETSEARCH_CASES = {
    "network": {
        "workload": {"model": "vgg16"}, "hardware": _NET_HW,
        "search": _NET_SEARCH},
    "network_codse": {
        "workload": {"model": "vgg16"},
        "hardware": dict(_NET_HW, pe_range=list(range(32, 513, 32)),
                         bw_range=[float(b) for b in range(4, 65, 4)]),
        "search": dict(_NET_SEARCH, frontier_k=4)},
    "run_many": {
        "model": "vgg16", "layer": "all",
        "hardware": {"num_pes": 256, "noc_bw": 32.0},
        "search": {"objective": "edp", "budget": 1000, "strategy": "auto",
                   "seed": 0, "top_k": 5, "population": None,
                   "cluster": True, "dims": None, "l1_prune_kb": None,
                   "l2_prune_kb": None, "block": 1024, "pipeline": "gene",
                   "codse_top_k": 4, "joint_genes": 0}},
}


def _wire_conv(tag: str, name: str, *, k: int = 8, c: int = 6,
               objective: str = "edp") -> dict:
    """``tests/test_serve.py::wire_conv``'s query (y = x = 10, 3x3)."""
    return {"tag": tag,
            "workload": {"op": {"type": "conv2d", "name": name, "k": k,
                                "c": c, "y": 10, "x": 10, "r": 3,
                                "s": 3}},
            "hardware": {"num_pes": 48, "noc_bw": 12.0},
            "search": {"objective": objective, "budget": 32, "block": 64,
                       "top_k": 4}}


# tests/test_serve.py's QUERIES, answered as one flush
SERVE_CASES = {
    "serve": {"flush": [_wire_conv("a", "sv-a"),
                        _wire_conv("b", "sv-b", k=12, objective="runtime"),
                        _wire_conv("c", "sv-c", c=8, objective="energy")]},
}
SETS = {"front_door": (CASES, OUT),
        "netsearch": (NETSEARCH_CASES,
                      ROOT / "tests" / "data" /
                      "torch_netsearch_fixture.json"),
        "serve": (SERVE_CASES,
                  ROOT / "tests" / "data" / "torch_serve_fixture.json")}

# report fields that time the run, not answer it
VOLATILE = ("timing", "rates", "compile_s", "eval_s", "encode_s",
            "elapsed_s", "n_compiles", "designs_per_s")


def query_json(case: dict, dse_config) -> dict:
    """A case's query dict with its "default" ranges filled in from the
    given package's ``DSEConfig`` class."""
    q = json.loads(json.dumps(case))
    hw = q["hardware"]
    for k in ("pe_range", "bw_range"):
        if hw.get(k) == "default":
            hw[k] = list(getattr(dse_config(), k))
    return q


def layer_batch(case: dict, api, zoo) -> list:
    """A ``run_many`` case's queries, one per selected layer, made by the
    given package's ``api`` and ``core.dnn_models`` as the mapsearch CLI
    makes them (``Workload.of_layer`` of each layer; such a workload's
    JSON names its layer and does not rebuild it, so the fixture keeps
    each query's ``describe()`` and fingerprint)."""
    hw = api.Hardware.from_json(case["hardware"])
    spec = api.SearchSpec.from_json(case["search"])
    layers = api.select_layers(zoo.MODELS[case["model"]](), case["layer"])
    return [api.Query(api.Workload.of_layer(op), hw, spec) for op in layers]


def comparable(report: dict) -> dict:
    """A report's JSON without the fields that time the run."""
    if isinstance(report, dict):
        return {k: comparable(v) for k, v in report.items()
                if k not in VOLATILE}
    if isinstance(report, list):
        return [comparable(v) for v in report]
    return report


def _near(a, b, rtol: float) -> bool:
    return a == b or (math.isfinite(b) and abs(a - b) <= rtol * abs(b))


def compare(got, want, rtol: float = RTOL, path: str = "") -> None:
    """``got`` against ``want`` field by field: the same keys, lists of
    the same length, numbers within ``rtol`` (exact for ints and bools),
    everything else equal.  Raises ``AssertionError`` naming the path."""
    where = path or "report"
    if isinstance(want, dict):
        assert isinstance(got, dict), f"{where}: {got!r} is not a dict"
        assert got.keys() == want.keys(), (
            f"{where}: keys {sorted(got)} vs {sorted(want)}")
        for k in want:
            compare(got[k], want[k], rtol, f"{path}.{k}" if path else k)
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), (
            f"{where}: {got!r} vs {want!r}")
        for i, (g, w) in enumerate(zip(got, want)):
            compare(g, w, rtol, f"{where}[{i}]")
    elif isinstance(want, float) and not isinstance(got, bool):
        assert isinstance(got, (int, float)) and _near(got, want, rtol), (
            f"{where}: {got!r} vs {want!r} (rtol {rtol})")
    else:
        assert got == want and type(got) is type(want), (
            f"{where}: {got!r} vs {want!r}")


def compare_ranking(got: list, want: list, rtol: float = RTOL,
                    label: str = "top_k") -> int:
    """Two top-k lists of {"point", "value", "stats"}: the points in the
    same order, except that entries whose ``want`` values lie within
    ``rtol`` of each other may swap (and at the end of the list a point
    of such a tie from outside ``want`` may come in); values and the
    stats of every point both lists hold within ``rtol``.  Returns how
    many positions were swapped."""
    assert len(got) == len(want), f"{label}: {len(got)} vs {len(want)}"
    by_point = {tuple(e["point"]): e for e in want}
    swapped = 0
    for i, (g, w) in enumerate(zip(got, want)):
        assert _near(g["value"], w["value"], rtol), (
            f"{label}[{i}]: value {g['value']!r} vs {w['value']!r}")
        gp = tuple(g["point"])
        if gp != tuple(w["point"]):
            swapped += 1
            if gp in by_point:
                assert _near(by_point[gp]["value"], w["value"], rtol), (
                    f"{label}[{i}]: {gp} swapped outside a tie")
            else:
                assert all(_near(e["value"], w["value"], rtol)
                           for e in want[i:]), (
                    f"{label}[{i}]: {gp} is not in the reference's top-k "
                    f"and not in its last tie")
        if gp in by_point:
            compare(g["stats"], by_point[gp]["stats"], rtol,
                    f"{label}[{i}].stats")
    return swapped


def compare_reports(got: dict, want: dict, rtol: float = RTOL) -> int:
    """A port report's JSON against the reference's, field by field
    (``comparable`` slices of both), with a top-k of points (and a layer
    report's best) held by ``compare_ranking``.  Returns the tied
    swaps."""
    got, want = comparable(got), comparable(want)
    g_top, w_top = got.pop("top_k"), want.pop("top_k")
    if w_top and "point" not in w_top[0]:
        # a network co-DSE's top-k: designs re-composed by the DP, each
        # held field by field
        compare(g_top, w_top, rtol, "top_k")
        swaps = 0
    else:
        swaps = compare_ranking(g_top, w_top, rtol)
    if want["kind"] == "layer" and swaps:
        # a tie at the top: the best is the top-k's first entry
        g, w = got.pop("best"), want.pop("best")
        assert _near(g["value"], w["value"], rtol), (
            f"best: {g['value']!r} vs {w['value']!r}")
    compare(got, want, rtol)
    return swaps


def run_queries(queries: list[dict], batch: bool = False) -> list[dict]:
    """The JAX package's reports (JSON) for the given query dicts, in this
    process: one ``Session.run`` each, or with ``batch`` one
    ``Session.run_many`` over all of them."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro.api import Query, Session
    session = Session(cache_dir=None)
    qs = [Query.from_json(d) for d in queries]
    if batch:
        return [r.to_json() for r in session.run_many(qs)]
    out = []
    for q in qs:
        out.append(session.run(q).to_json())
        print(f"{q.kind} {q.fingerprint()}", file=sys.stderr)
    return out


def batch_stats(last_batch: dict) -> dict:
    """The deterministic part of ``Session.last_batch``."""
    return {k: last_batch[k] for k in ("n_queries", "n_coalesced",
                                       "coalesce", "n_families",
                                       "compile_budget")}


def run_case(name: str) -> dict:
    sys.path.insert(0, str(ROOT / "src"))
    from repro import api
    from repro.core import dnn_models
    from repro.core.dse import DSEConfig
    case = dict(CASES, **NETSEARCH_CASES, **SERVE_CASES)[name]
    if "flush" in case:
        from repro.serve import execute_batch
        queries = [api.Query.from_json(d) for d in case["flush"]]
        session = api.Session(cache_dir=None)
        reps = execute_batch(session, queries)
        return {"queries": case["flush"],
                "fingerprints": [q.fingerprint() for q in queries],
                "batch": batch_stats(session.last_batch),
                "reports": [comparable(r.to_json()) for r in reps]}
    if "layer" in case and "workload" not in case:
        queries = layer_batch(case, api, dnn_models)
        session = api.Session(cache_dir=None)
        reps = session.run_many(queries)
        return {"queries": [q.describe() for q in queries],
                "fingerprints": [q.fingerprint() for q in queries],
                "batch": batch_stats(session.last_batch),
                "reports": [comparable(r.to_json()) for r in reps]}
    d = query_json(case, DSEConfig)
    (rep,) = run_queries([d])
    return {"query": d, "fingerprint": api.Query.from_json(d).fingerprint(),
            "report": comparable(rep)}


def _cap_isa() -> None:
    flags = os.environ.get("XLA_FLAGS", "")
    if ISA_FLAG not in flags:
        os.environ["XLA_FLAGS"] = f"{flags} {ISA_FLAG}".strip()
    os.environ.setdefault("JAX_PLATFORMS", "cpu")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--set", default="front_door", choices=sorted(SETS),
                    help="which fixture file to make (default front_door)")
    ap.add_argument("--out", default=None,
                    help="where to write it (default: the set's file)")
    ap.add_argument("--cases", nargs="+", default=None,
                    help="make only these cases of the set")
    ap.add_argument("--queries", default=None,
                    help="JSON list of query dicts: write their reports")
    ap.add_argument("--batch", action="store_true",
                    help="with --queries: one Session.run_many batch")
    args = ap.parse_args()
    _cap_isa()
    cases, default_out = SETS[args.set]
    out = Path(args.out or default_out)
    out.parent.mkdir(parents=True, exist_ok=True)
    if args.queries:
        reports = run_queries(json.loads(Path(args.queries).read_text()),
                              batch=args.batch)
        out.write_text(json.dumps(reports))
        return
    args.cases = args.cases or sorted(cases)
    unknown = set(args.cases) - set(cases)
    if unknown:
        ap.error(f"not cases of the {args.set} set: {sorted(unknown)}")
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(
            max_workers=len(args.cases), mp_context=ctx) as pool:
        cases = dict(zip(args.cases, pool.map(run_case, args.cases)))
    import jax
    doc = {"made_by": "scripts/make_front_door_fixture.py",
           "jax": jax.__version__, "xla_flags": ISA_FLAG, "cases": cases}
    text = json.dumps(doc, indent=1, sort_keys=True)
    # one line per list of numbers (a point, a range), for a readable diff
    text = re.sub(r"\[[-0-9.e,\s]+\]",
                  lambda m: " ".join(m.group(0).split()), text)
    out.write_text(text + "\n")


if __name__ == "__main__":
    main()
