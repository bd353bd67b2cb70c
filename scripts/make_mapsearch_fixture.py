#!/usr/bin/env python3
"""Write the JAX package's mapping-search results that the PyTorch port is
held against: ``tests/data/torch_mapsearch_fixture.json``.

    PYTHONPATH=src python3 scripts/make_mapsearch_fixture.py [--out PATH]
        [--cases PATTERN ...]

Each case is one ``repro.mapspace.search.search_impl`` call, stored with
the arguments that make it (``case["spec"]``, read back by
``build_case`` here, which ``tests/test_torch_mapspace.py`` and
``chip_smoke.py::phase_mapsearch`` import) and its result: strategy, best point
and value, the top-k points, values and feature rows, mappings evaluated
and structure groups.  The cases are the VGG16 conv13 72-group space
(10368 mappings; exhaustive, and a greedy search under a smaller budget)
and small conv spaces for the CPU tests (both pipelines, every strategy
that draws with numpy, a throughput objective and an L1 budget).

The reference runs on the CPU with XLA's CPU code generation capped at
AVX (``--xla_cpu_max_isa=AVX``, set here before JAX loads): on a host
with FMA, XLA contracts ``a * b + c`` into one fused multiply-add where
its fusion puts the two together, which rounds once where the program
rounds twice, and the results would then depend on the host's CPU.
Capped, the executables compute the program as written, and the file is
the same on every x86 host.  Cases that share executables (same layer,
space, pipeline and objective) run in one process, and the processes run
side by side; the file does not depend on the grouping.  ``--cases``
makes only the cases whose names match one of the given ``fnmatch``
patterns (the CPU test remakes the small ones this way and compares
them with the committed file).
"""
from __future__ import annotations

import argparse
import concurrent.futures
import fnmatch
import json
import multiprocessing
import os
import re
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "tests" / "data" / "torch_mapsearch_fixture.json"
ISA_FLAG = "--xla_cpu_max_isa=AVX"

SMALL_CONV = {"name": "gene-conv", "k": 8, "c": 6, "y": 12, "x": 12,
              "r": 3, "s": 3}
CONV_SPACE = {"dims": ["K", "C", "Y"], "cluster_sizes": [8],
              "perm_mode": "all"}
FLAT_SPACE = {"dims": ["K", "C"], "cluster": False}
CONV13_SPACE = {"dims": ["K", "C", "X"], "perm_mode": "all",
                "cluster_sizes": [32, 64]}
SMALL_HW = {"num_pes": 48, "noc_bw": 12.0, "block": 64}
CONV13_HW = {"num_pes": 256, "noc_bw": 32.0, "block": 1024, "top_k": 8}


def case_specs() -> dict[str, dict]:
    """name -> {"layer": ..., "space": build_space kwargs, "search":
    search_impl kwargs}; ``layer`` is a VGG16 layer name or the kwargs of
    ``tensor_analysis.conv2d``.  ``search["l1_budget_kb"] == "median"``
    stands for the median L1 estimate over the whole space."""
    specs: dict[str, dict] = {
        "conv13/exhaustive": {
            "layer": "vgg16-conv13", "space": CONV13_SPACE,
            "search": dict(CONV13_HW, objective="edp", budget=10368,
                           strategy="exhaustive", seed=0)},
        "conv13/greedy": {
            "layer": "vgg16-conv13", "space": CONV13_SPACE,
            "search": dict(CONV13_HW, objective="edp", budget=2048,
                           strategy="auto", seed=0)},
    }
    for pipe in ("gene", "legacy"):
        small = [
            ("conv/exhaustive", CONV_SPACE,
             dict(strategy="exhaustive", budget=10_000, seed=0)),
            ("conv/random", CONV_SPACE,
             dict(strategy="random", budget=150, seed=0)),
            ("conv/greedy", CONV_SPACE,
             dict(strategy="greedy", budget=150, seed=0)),
            ("flat/exhaustive", FLAT_SPACE,
             dict(strategy="exhaustive", budget=10_000, seed=0)),
            ("conv/random-l1", CONV_SPACE,
             dict(strategy="random", budget=120, seed=2,
                  l1_budget_kb="median")),
            ("conv/greedy-throughput", CONV_SPACE,
             dict(strategy="greedy", budget=120, seed=3,
                  objective="throughput")),
        ]
        for name, space, kw in small:
            specs[f"{name}/{pipe}"] = {
                "layer": SMALL_CONV, "space": space,
                "search": dict({"objective": "edp", **SMALL_HW, **kw},
                               pipeline=pipe)}
    return specs


def build_case(spec: dict, ta, dnn_models, mapspace):
    """(op, space, search kwargs) of one case in either package (``ta``,
    ``dnn_models`` and ``mapspace`` are that package's modules)."""
    layer = spec["layer"]
    if isinstance(layer, str):
        op = next(o for o in dnn_models.vgg16() if o.name == layer)
    else:
        op = ta.conv2d(**layer)
    space_kw = dict(spec["space"])
    for k in ("dims", "cluster_sizes"):
        if k in space_kw:
            space_kw[k] = tuple(space_kw[k])
    space = mapspace.build_space(op, **space_kw)
    kw = dict(spec["search"])
    if kw.get("l1_budget_kb") == "median":
        l1, _ = mapspace.buffer_estimates_genes(
            op, space, mapspace.enumerate_genes(space))
        kw["l1_budget_kb"] = float(np.median(l1))
    return op, space, kw


def result_record(r) -> dict:
    return {
        "strategy": r.strategy,
        "best_point": [int(x) for x in r.best_point],
        "best_value": float(r.best_value),
        "top_k": [{"point": [int(x) for x in e["point"]],
                   "value": float(e["value"]),
                   "stats": {k: float(v) for k, v in e["stats"].items()}}
                  for e in r.top_k],
        "n_evaluated": int(r.n_evaluated),
        "n_groups": int(r.n_groups),
    }


def run_cases(names: list[str]) -> dict[str, dict]:
    """Run the named cases with the JAX package (in this process)."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro.core import dnn_models, tensor_analysis as ta
    from repro import mapspace
    from repro.mapspace.search import search_impl

    specs = case_specs()
    cases = {}
    for name in names:
        op, space, kw = build_case(specs[name], ta, dnn_models, mapspace)
        r = search_impl(op, space=space, **kw)
        cases[name] = {"spec": specs[name], "space_size": int(space.size),
                       "space_groups": int(space.n_groups),
                       "result": result_record(r)}
        print(f"{name}: {r.strategy} best {r.best_value:.6e} "
              f"at {tuple(r.best_point)}, {r.n_evaluated} evaluated",
              file=sys.stderr)
    return cases


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(OUT))
    ap.add_argument("--cases", nargs="+", default=["*"],
                    help="fnmatch patterns of the case names to make")
    args = ap.parse_args()
    flags = os.environ.get("XLA_FLAGS", "")
    if ISA_FLAG not in flags:
        os.environ["XLA_FLAGS"] = f"{flags} {ISA_FLAG}".strip()
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    # cases that share executables (op, space, pipeline, objective) stay
    # in one process
    groups: dict[tuple, list[str]] = {}
    for name, spec in case_specs().items():
        if not any(fnmatch.fnmatchcase(name, p) for p in args.cases):
            continue
        kw = spec["search"]
        key = (json.dumps(spec["layer"]), json.dumps(spec["space"]),
               kw.get("pipeline", "gene"), kw["objective"])
        groups.setdefault(key, []).append(name)
    cases: dict[str, dict] = {}
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(
            max_workers=len(groups), mp_context=ctx) as pool:
        for part in pool.map(run_cases, list(groups.values())):
            cases.update(part)
    import jax
    doc = {"made_by": "scripts/make_mapsearch_fixture.py",
           "jax": jax.__version__, "xla_flags": ISA_FLAG,
           "cases": cases}
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    text = json.dumps(doc, indent=1, sort_keys=True)
    # one line per list of numbers (a point), for a readable diff
    text = re.sub(r"\[[-0-9.e,\s]+\]",
                  lambda m: " ".join(m.group(0).split()), text)
    out.write_text(text + "\n")


if __name__ == "__main__":
    main()
