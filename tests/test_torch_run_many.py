"""Port of the front door's batch half (``Session.run_many``,
``submit``/``flush``, the module-level ``run_many`` and
``launch/query.py --file``) against the JAX package's ``repro.api``.

  * tests/test_api.py's heterogeneous batch (conv, fc and gemm layers,
    four objectives, three hardware points) answered coalesced: at most
    one warm-up pass per (op-class, level-count) family, the warm-up
    budget, ``coalesce=False`` equal to the coalesced answer, submit and
    flush, a mixed batch that routes its network query uncoalesced, a
    killed flush resumed from its sweep checkpoint;
  * every report of that batch, and of ``examples/queries.json`` through
    ``run_many`` and through ``launch/query.py --file --device cpu``,
    against the reference's ``run_many`` reports (points identical, values
    at rtol 1e-6, top-k swaps only within 1e-6 ties, timings exempt).  The
    reference runs in processes of its own, AVX-capped
    (``scripts/make_front_door_fixture.py --queries FILE --batch``).

Everything runs with ``device="cpu"``."""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.api import (Hardware, Query, SearchSpec,  # noqa: E402
                             Session, Workload)
from repro_torch.core import tensor_analysis as ta  # noqa: E402
from repro_torch.launch import query as cli  # noqa: E402
from repro_torch.resilience import (ResilienceConfig, RetryPolicy,  # noqa: E402
                                    SweepKilled, faultinject,
                                    set_default_policy)
from torch_scripts import load_script  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SCRIPT = ROOT / "scripts" / "make_front_door_fixture.py"
EXAMPLES = ROOT / "examples" / "queries.json"
fx = load_script("make_front_door_fixture")

PES, BW = 48, 12.0
BLOCK = 64
CHAIN = [ta.conv2d("api-t-n1", k=8, c=4, y=12, x=12, r=3, s=3),
         ta.conv2d("api-t-n2", k=12, c=8, y=14, x=14, r=3, s=3),
         ta.fc("api-t-f1", k=16, c=32)]
# tests/test_api.py's batch, as query JSON
BATCH_OPS = [
    {"type": "conv2d", "name": "api-b-c1", "k": 8, "c": 4, "y": 12,
     "x": 12, "r": 3, "s": 3},
    {"type": "conv2d", "name": "api-b-c2", "k": 12, "c": 8, "y": 10,
     "x": 10, "r": 3, "s": 3},
    {"type": "conv2d", "name": "api-b-c3", "k": 6, "c": 6, "y": 8, "x": 8,
     "r": 3, "s": 3},
    {"type": "fc", "name": "api-b-f1", "k": 16, "c": 32},
    {"type": "gemm", "name": "api-b-g1", "m": 8, "n": 24, "k": 16},
    {"type": "conv2d", "name": "api-b-c4", "k": 4, "c": 8, "y": 14,
     "x": 14, "r": 3, "s": 3},
]
TEST_BATCH = [
    {"workload": {"op": op},
     "hardware": {"num_pes": 32 + 16 * (i % 2), "noc_bw": 8.0 + 4 * (i % 3)},
     "search": {"objective": obj, "budget": 50, "block": BLOCK,
                "top_k": 3}}
    for i, (op, obj) in enumerate(zip(
        BATCH_OPS, ["edp", "energy", "runtime", "throughput", "edp",
                    "energy"]))]


@pytest.fixture(scope="module")
def session():
    return Session(device="cpu")


@pytest.fixture(scope="module")
def batch_queries():
    return [Query.from_json(d) for d in TEST_BATCH]


@pytest.fixture
def fast_retry():
    """A resilience config whose retry policy does not sleep; restores
    the process default afterwards."""
    yield ResilienceConfig(retry=RetryPolicy(backoff_s=0.0))
    set_default_policy(None)


@pytest.fixture(scope="module")
def reference_runs(tmp_path_factory):
    """The JAX package's ``Session.run_many`` report JSONs, AVX-capped,
    two processes side by side: every query of ``examples/queries.json``
    (the batch ``launch/query.py --file`` answers) and ``TEST_BATCH``."""
    d = tmp_path_factory.mktemp("batch_ref")
    jobs = {"examples": json.loads(EXAMPLES.read_text())["queries"],
            "batch": TEST_BATCH}
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    procs = {}
    for name, queries in jobs.items():
        (d / f"{name}-q.json").write_text(json.dumps(queries))
        procs[name] = subprocess.Popen(
            [sys.executable, str(SCRIPT), "--queries",
             str(d / f"{name}-q.json"), "--batch", "--out",
             str(d / f"{name}-r.json")], env=env,
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    out = {}
    for name, p in procs.items():
        _, err = p.communicate(timeout=600)
        assert p.returncode == 0, err.decode()[-2000:]
        out[name] = json.loads((d / f"{name}-r.json").read_text())
    return out


@pytest.fixture(scope="module")
def batch_reports(session, batch_queries):
    """One coalesced run shared by the batching tests."""
    from repro_torch.mapspace.universal import compile_count
    c0 = compile_count()
    reports = session.run_many(batch_queries)
    return reports, dict(session.last_batch), compile_count() - c0


def test_run_many_compile_budget(batch_reports, batch_queries):
    reports, batch, compiles = batch_reports
    assert len(reports) == len(batch_queries)
    assert batch["n_coalesced"] == len(batch_queries)
    # at most ONE warm-up pass per unique (op-class, level-count) family
    assert compiles <= batch["n_families"]
    assert batch["n_compiles"] <= batch["compile_budget"]
    for q, rep in zip(batch_queries, reports):
        assert rep.kind == "layer" and rep.coalesced
        assert rep.objective == q.search.objective
        assert rep.n_evaluated > 0
        assert len(rep.top_k) <= q.search.top_k
        assert np.isfinite(rep.best["value"])
        # winning genes stay decodable: raw ships the family space
        assert rep.raw.best_dataflow.directives
        vals = [e["value"] for e in rep.top_k]
        if q.search.objective == "throughput":
            assert vals == sorted(vals, reverse=True)
        else:
            assert vals == sorted(vals)


def test_run_many_coalesced_vs_sequential(session, batch_queries,
                                          batch_reports):
    reports, _, _ = batch_reports
    seq = session.run_many(batch_queries, coalesce=False)
    assert session.last_batch["n_compiles"] == 0   # families stay warm
    for a, b in zip(reports, seq):
        assert a.results_json() == b.results_json()
        assert a.coalesced and not b.coalesced
    assert session.metrics()["session"]["last_batch"] == \
        session.last_batch


def test_run_many_matches_the_reference_batch(batch_reports,
                                              reference_runs):
    """The same batch through the JAX package's ``run_many``: every
    report held field by field (points identical, values at rtol
    1e-6)."""
    reports, _, _ = batch_reports
    for rep, want in zip(reports, reference_runs["batch"]):
        fx.compare_reports(rep.to_json(), want)


def test_submit_flush(session, batch_queries):
    pending = [session.submit(q) for q in batch_queries[:3]]
    assert not any(p.done() for p in pending)
    first = pending[0].result()          # triggers the flush
    assert all(p.done() for p in pending)
    assert first.results_json() == pending[0].result().results_json()
    assert session.last_batch["n_queries"] == 3
    assert session.flush() == []


def test_mixed_batch_routes_non_coalescible(session, monkeypatch):
    qs = [Query(Workload.of_layer(CHAIN[0]),
                Hardware(num_pes=PES, noc_bw=BW),
                SearchSpec(budget=40, block=BLOCK)),
          Query(Workload.of_layers(CHAIN), Hardware(num_pes=PES, noc_bw=BW),
                SearchSpec(budget=40, block=BLOCK, frontier_k=2,
                           budget_policy="uniform"))]
    reports = session.run_many(qs)
    assert [r.kind for r in reports] == ["layer", "network"]
    assert reports[0].coalesced and not reports[1].coalesced
    assert session.last_batch["n_coalesced"] == 1
    from repro_torch.api import run_many, session as session_mod
    monkeypatch.setattr(session_mod, "_DEFAULT", Session(device="cpu"))
    again = run_many(qs)            # the module-level one-shot
    assert [r.results_json() for r in again] == \
        [r.results_json() for r in reports]


def test_run_many_kill_resume_bit_identical(tmp_path, batch_queries,
                                            fast_retry):
    """A flush killed mid-pass resumes from its sweep checkpoint to the
    same answers, and clears the checkpoint."""
    qs = batch_queries[:2]
    clean = Session(device="cpu").run_many(qs)
    cfg = dataclasses.replace(fast_retry, ckpt_dir=str(tmp_path))
    with faultinject.scoped("kill@chunk:1"):
        with pytest.raises(SweepKilled):
            Session(device="cpu", resilience=cfg).run_many(qs)
    assert any(f.startswith("sweep-batch-") for f in os.listdir(tmp_path))
    resumed = Session(device="cpu", resilience=cfg).run_many(qs)
    assert [r.results_json() for r in resumed] == \
        [r.results_json() for r in clean]
    assert not os.listdir(tmp_path)


def test_examples_through_run_many_match_the_reference(reference_runs):
    """Every query of ``examples/queries.json`` (coalesced layers, an
    adaptive network query, a grid co-DSE) through ``Session.run_many``,
    held against the reference's batch report by report."""
    qs = [Query.from_json(d) for d in
          json.loads(EXAMPLES.read_text())["queries"]]
    reps = Session(device="cpu").run_many(qs)
    want_all = reference_runs["examples"]
    assert [r.kind for r in reps] == [r["kind"] for r in want_all]
    for rep, want in zip(reps, want_all):
        fx.compare_reports(rep.to_json(), want)


def test_query_cli_file_matches_the_reference(reference_runs, tmp_path,
                                              capsys):
    out = tmp_path / "reports.json"
    cli.main(["--file", str(EXAMPLES), "--device", "cpu", "--cache-dir",
              "", "--out", str(out)])
    text = capsys.readouterr().out
    assert "=== query 4 [small-network-adaptive]: network" in text
    assert "# batch: 6 queries (4 coalesced" in text
    doc = json.loads(out.read_text())
    assert doc["batch"]["n_queries"] == 6
    assert doc["environment"]["backend"] == "cpu"
    for got, want in zip(doc["reports"], reference_runs["examples"]):
        fx.compare_reports(got, want)
