"""Port of the declarative front door (``repro_torch.api``, layer half)
against the JAX package's ``repro.api``.

  * the spec machinery: kinds, JSON, validation, and fingerprints that are
    the same hex digest in both packages;
  * the wrapper contract: ``mapspace.search``/``co_search`` bit-equal to
    ``Session.run`` on the equivalent query;
  * ``Report`` JSON: the round trip, forward compatibility, the timeout
    constructor, and the port's reports field by field against the
    reference's for the layer and ``layer_codse`` queries of
    ``examples/queries.json`` and of this file (points and top-k order
    identical but for swaps within 1e-6 ties, values at rtol 1e-6,
    timings exempt).  The reference runs in processes of its own with
    XLA's CPU code generation capped at AVX
    (``scripts/make_front_door_fixture.py --queries``), as the committed
    fixture is made, so that no FMA contraction moves its values;
  * the result cache keyed by the query fingerprint; the degrade path;
    deadlines; what the port does not have yet raises.

Everything runs with ``device="cpu"``."""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import repro.api as japi  # noqa: E402
from repro_torch import mapspace as tms  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.api import (Hardware, Query, Report,  # noqa: E402
                             SearchSpec, Session, Workload)
from repro_torch.api import spec as tspec  # noqa: E402
from repro_torch.core import tensor_analysis as ta  # noqa: E402
from repro_torch.core.dse import DSEConfig  # noqa: E402
from repro_torch.launch import mapsearch, query as cli  # noqa: E402
from repro_torch.mapspace import cache as ms_cache  # noqa: E402
from repro_torch.mapspace.space import build_space  # noqa: E402
from repro_torch.resilience import (BudgetExceeded, DeviceError,  # noqa: E402
                                    ResilienceConfig, RetryPolicy,
                                    SpecError, faultinject,
                                    set_default_policy)
from torch_scripts import load_script  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SCRIPT = ROOT / "scripts" / "make_front_door_fixture.py"
FIXTURE = ROOT / "tests" / "data" / "torch_front_door_fixture.json"
EXAMPLES = ROOT / "examples" / "queries.json"

fx = load_script("make_front_door_fixture")

PES, BW = 48, 12.0
BLOCK = 64
CONV = {"type": "conv2d", "name": "api-t-c1", "k": 8, "c": 4, "y": 12,
        "x": 12, "r": 3, "s": 3}
GRID = {"pe_range": [16, 32, 64], "bw_range": [4.0, 8.0, 16.0]}
# the queries of tests/test_api.py that this file runs, as JSON
TEST_QUERIES = {
    "search-parity": {
        "workload": {"op": CONV},
        "hardware": {"num_pes": PES, "noc_bw": BW},
        "search": {"objective": "edp", "budget": 60, "block": BLOCK,
                   "top_k": 4}},
    "co-search-parity": {
        "workload": {"op": CONV},
        "hardware": {"num_pes": PES, "noc_bw": BW, **GRID},
        "search": {"objective": "edp", "budget": 60, "block": BLOCK,
                   "top_k": 4, "codse_top_k": 2}},
    "roundtrip": {
        "tag": "rt", "workload": {"op": CONV},
        "hardware": {"num_pes": PES, "noc_bw": BW},
        "search": {"budget": 40, "block": BLOCK}},
}
EXAMPLE_QUERIES = {d["tag"]: d for d in
                   json.loads(EXAMPLES.read_text())["queries"]}
LAYER_QUERIES = dict(TEST_QUERIES, **{
    tag: d for tag, d in EXAMPLE_QUERIES.items()
    if Query.from_json(d).kind in ("layer", "layer_codse")})


@pytest.fixture(scope="module")
def conv():
    return ta.conv2d("api-t-c1", k=8, c=4, y=12, x=12, r=3, s=3)


@pytest.fixture(scope="module")
def session():
    return Session(device="cpu")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """{tag: report JSON} of the JAX package's ``Session.run`` on
    ``LAYER_QUERIES``, AVX-capped: three processes side by side."""
    d = tmp_path_factory.mktemp("front_door_ref")
    tags = sorted(LAYER_QUERIES)
    parts = [tags[i::3] for i in range(3)]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    procs = []
    for i, part in enumerate(parts):
        (d / f"q{i}.json").write_text(json.dumps(
            [LAYER_QUERIES[t] for t in part]))
        procs.append(subprocess.Popen(
            [sys.executable, str(SCRIPT), "--queries", str(d / f"q{i}.json"),
             "--out", str(d / f"r{i}.json")], env=env,
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE))
    out = {}
    for i, (p, part) in enumerate(zip(procs, parts)):
        _, err = p.communicate(timeout=600)
        assert p.returncode == 0, err.decode()[-2000:]
        out.update(zip(part, json.loads((d / f"r{i}.json").read_text())))
    return out


# ----------------------------------------------------------------------
# Spec machinery
# ----------------------------------------------------------------------

def test_query_kinds(conv):
    chain = [conv, ta.fc("api-t-f1", k=16, c=32)]
    fixed, grid = Hardware(), Hardware(pe_range=(32, 64))
    assert Query(Workload.of_layer(conv), fixed).kind == "layer"
    assert Query(Workload.of_layer(conv), grid).kind == "layer_codse"
    assert Query(Workload.of_layers(chain), fixed).kind == "network"
    assert Query(Workload.of_network("vgg16"), grid).kind == \
        "network_codse"
    assert Query(Workload(model="vgg16", layer="conv13"),
                 fixed).kind == "layer"


def test_query_json_and_fingerprint():
    d = {"tag": "t", "workload": {"op": {"type": "conv2d", "name": "j1",
                                         "k": 8, "c": 4, "y": 12,
                                         "x": 12, "r": 3, "s": 3}},
         "hardware": {"num_pes": 64, "pe_range": [32, 64]},
         "search": {"objective": "energy", "budget": 77}}
    q = Query.from_json(d)
    assert q.kind == "layer_codse"
    assert q.hardware.pe_range == (32, 64)
    assert q.search.budget == 77
    # fingerprint is stable and sensitive to every component
    assert q.fingerprint() == Query.from_json(d).fingerprint()
    d2 = json.loads(json.dumps(d))
    d2["search"]["budget"] = 78
    assert Query.from_json(d2).fingerprint() != q.fingerprint()
    # invalid specs are rejected loudly
    with pytest.raises(ValueError):
        Query.from_json({"workload": {"op": {"type": "nope"}}})
    with pytest.raises(ValueError):
        Query.from_json({"workload": {"model": "vgg16"},
                         "search": {"not_a_knob": 1}})


@pytest.mark.parametrize("d", [q for q in EXAMPLE_QUERIES.values()]
                         + list(TEST_QUERIES.values()),
                         ids=list(EXAMPLE_QUERIES) + list(TEST_QUERIES))
def test_fingerprints_match_the_reference(d):
    """The same hex digest in both packages, network queries included
    (a fingerprint is pure data: it keys both packages' result caches)."""
    mine, ref = Query.from_json(d), japi.Query.from_json(d)
    assert tspec.SCHEMA_VERSION == japi.SCHEMA_VERSION
    assert mine.kind == ref.kind
    assert mine.describe() == ref.describe()
    assert mine.fingerprint() == ref.fingerprint()
    assert mine.estimated_cost() == ref.estimated_cost()


def test_fingerprints_of_model_workloads_match_the_reference():
    for name, wl in (("vgg16", "conv13"), ("resnet50", None),
                     ("vgg16", "0,2")):
        mine = Query(Workload(model=name, layer=wl),
                     Hardware(pe_range=tuple(DSEConfig().pe_range)))
        ref = japi.Query(japi.Workload(model=name, layer=wl),
                         japi.Hardware(pe_range=tuple(DSEConfig().pe_range)))
        assert mine.fingerprint() == ref.fingerprint()
        assert [o.name for o in mine.workload.resolve()] == \
            [o.name for o in ref.workload.resolve()]


def test_workload_validation(conv):
    with pytest.raises(ValueError):
        Workload()
    with pytest.raises(ValueError):
        Workload(model="vgg16", ops=(conv,))
    with pytest.raises(ValueError):
        Workload.of_network("not-a-model")


def test_enum_literals_agree_with_the_engine():
    assert set(tspec.VALID_OBJECTIVES) == set(tms.OBJECTIVES)
    assert set(tspec.VALID_STRATEGIES) == set(tms.STRATEGIES) | {"auto"}
    assert tspec.VALID_PIPELINES == tms.PIPELINES
    assert sorted(tspec.OP_BUILDERS) == sorted(japi.OP_BUILDERS)


# ----------------------------------------------------------------------
# Wrapper contract: legacy entry points bit-equal to Session.run
# ----------------------------------------------------------------------

def test_search_parity(session, conv):
    q = Query.from_json(TEST_QUERIES["search-parity"])
    rep = session.run(q)
    r = tms.search(conv, objective="edp", budget=60, num_pes=PES,
                   noc_bw=BW, block=BLOCK, top_k=4, device="cpu")
    assert list(r.best_point) == rep.best["point"]
    assert r.best_value == rep.best["value"]
    assert [list(e["point"]) for e in r.top_k] == \
        [e["point"] for e in rep.top_k]
    assert [e["value"] for e in r.top_k] == \
        [e["value"] for e in rep.top_k]
    assert r.best_stats == rep.best["stats"]
    assert rep.kind == "layer" and rep.raw.n_evaluated == r.n_evaluated


def test_co_search_parity(session, conv):
    cfg = DSEConfig(pe_range=(16, 32, 64), bw_range=(4.0, 8.0, 16.0))
    rep = session.run(Query.from_json(TEST_QUERIES["co-search-parity"]))
    co = tms.co_search(conv, objective="edp", mapping_budget=60, top_k=2,
                       cfg=cfg, num_pes=PES, noc_bw=BW, seed=0,
                       search_kwargs=dict(strategy="auto", top_k=4,
                                          population=None, block=BLOCK,
                                          multicast=True,
                                          spatial_reduction=True,
                                          l1_budget_kb=None,
                                          l2_budget_kb=None, devices=None),
                       device="cpu")
    assert rep.kind == "layer_codse"
    assert rep.pareto == json.loads(json.dumps(
        Report.from_codse(co).pareto))
    assert rep.best["per_objective"] == Report.from_codse(co).best[
        "per_objective"]
    assert rep.n_evaluated == co.n_evaluated


def test_run_search_and_default_session_count_queries(conv):
    from repro_torch.api.session import default_session
    s = default_session()
    n = s.n_queries
    a = tms.search(conv, budget=30, num_pes=PES, noc_bw=BW, block=BLOCK,
                   device="cpu")
    assert s.n_queries == n + 1
    b = Session(device="cpu").run_search(conv, budget=30, num_pes=PES,
                                         noc_bw=BW, block=BLOCK)
    assert (a.best_point, a.best_value, a.top_k) == \
        (b.best_point, b.best_value, b.top_k)


# ----------------------------------------------------------------------
# Port reports against the reference's, field by field
# ----------------------------------------------------------------------

@pytest.mark.parametrize("tag", sorted(LAYER_QUERIES))
def test_reports_match_the_reference(session, reference, tag):
    rep = session.run(Query.from_json(LAYER_QUERIES[tag]))
    ref = reference[tag]
    assert set(rep.to_json()) == set(ref)
    fx.compare_reports(rep.to_json(), ref)
    assert rep.to_json()["query"] == ref["query"]
    assert sorted(rep.extras["timing"]) == sorted(ref["timing"])


def test_fixture_queries_match_on_the_cpu(session):
    """The chip script's two vgg16-conv13 queries at full size, here on
    the CPU: the same query JSON and fingerprints as the committed JAX
    fixture, and reports that match it."""
    want = json.loads(FIXTURE.read_text())["cases"]
    for name in fx.CASES:
        d = fx.query_json(fx.CASES[name], DSEConfig)
        assert d == want[name]["query"]
        q = Query.from_json(d)
        assert q.fingerprint() == want[name]["fingerprint"]
        assert fx.compare_reports(session.run(q).to_json(),
                                  want[name]["report"]) == 0


def test_fixture_is_what_the_script_makes(tmp_path):
    """The JAX package, run now through the script, makes the committed
    file (both cases, ~35 s in two processes side by side)."""
    out = tmp_path / "fixture.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    subprocess.run([sys.executable, str(SCRIPT), "--out", str(out)],
                   env=env, check=True, capture_output=True, timeout=900)
    assert json.loads(out.read_text()) == json.loads(FIXTURE.read_text())


def test_compare_reports_catches_a_moved_point_and_value():
    want = json.loads(FIXTURE.read_text())["cases"]["layer"]["report"]
    assert fx.compare_reports(json.loads(json.dumps(want)), want) == 0
    bad = json.loads(json.dumps(want))
    bad["top_k"][1]["value"] *= 1 + 1e-5
    with pytest.raises(AssertionError, match="top_k"):
        fx.compare_reports(bad, want)
    bad = json.loads(json.dumps(want))
    bad["best"]["point"][0] += 1
    with pytest.raises(AssertionError, match="best.point"):
        fx.compare_reports(bad, want)
    codse = json.loads(FIXTURE.read_text())["cases"]["layer_codse"]["report"]
    bad = json.loads(json.dumps(codse))
    bad["pareto"][3]["num_pes"] += 8
    with pytest.raises(AssertionError, match="pareto"):
        fx.compare_reports(bad, codse)


# ----------------------------------------------------------------------
# Report JSON round trip
# ----------------------------------------------------------------------

def test_report_roundtrip(session):
    reps = [session.run(Query.from_json(TEST_QUERIES[t]))
            for t in ("roundtrip", "co-search-parity")]
    for rep in reps:
        d = rep.to_json()
        rt = Report.from_json(json.loads(json.dumps(d)))
        assert rt.to_json() == d
        assert rt.best == rep.best and rt.kind == rep.kind
    bench = Report.bench("x", {"n_compiles": 3, "custom_key": 1.5},
                         device="cpu")
    d = bench.to_json()
    assert d["n_compiles"] == 3 and d["custom_key"] == 1.5
    assert Report.from_json(d).to_json() == d
    with pytest.raises(ValueError):
        Report(kind="bench", extras={"best": {}}).to_json()


def test_bench_reports_carry_torch_provenance():
    # the backend is the run's device, not the host's: a CPU run says cpu
    env = Report.bench("x", {}, device="cpu").to_json()["environment"]
    assert env == obs.environment("cpu")
    assert env["torch"] == torch.__version__
    assert env["cuda"] == torch.version.cuda
    assert env["backend"] == "cpu" and env["device_kind"] == "cpu"
    assert env["device_count"] == 1
    assert {"hostname", "platform", "python", "git_sha"} <= set(env)
    assert "jax" not in env
    assert Report.bench("x", {"environment": {"a": 1}}).to_json()[
        "environment"] == {"a": 1}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Report.bench("x", {})


def test_report_from_json_forward_compat(session):
    """A NEWER writer's payload loads on this reader: unknown top-level
    fields land in ``extras`` (and survive re-serialization); only a
    schema_version mismatch is a hard, one-line SpecError."""
    q = Query(Workload.of_layer(ta.conv2d("api-t-c1", k=8, c=4, y=12, x=12,
                                          r=3, s=3)),
              Hardware(num_pes=PES, noc_bw=BW),
              SearchSpec(budget=40, block=BLOCK), tag="fwd")
    d = session.run(q).to_json()
    d["a_future_field"] = {"nested": [1, 2]}
    d["another_one"] = "hello"
    rep = Report.from_json(d)
    assert rep.extras["a_future_field"] == {"nested": [1, 2]}
    assert rep.extras["another_one"] == "hello"
    assert rep.to_json()["a_future_field"] == {"nested": [1, 2]}

    bad = dict(d, schema_version=d["schema_version"] + 99)
    with pytest.raises(SpecError, match="schema_version") as ei:
        Report.from_json(bad)
    assert ei.value.field == "schema_version"


def test_report_timeout_constructor():
    qd = dict(TEST_QUERIES["roundtrip"], tag="to")
    q = Query.from_json(qd)
    rep = Report.timeout(q, deadline_s=1.5, waited_s=1.7, where="flush")
    assert rep.kind == "timeout" and rep.tag == "to"
    d = rep.to_json()
    assert d["timeout"] == {"deadline_s": 1.5, "waited_s": 1.7,
                            "where": "flush"}
    assert Report.from_json(d).extras["timeout"]["where"] == "flush"
    ref = japi.Report.timeout(japi.Query.from_json(qd), deadline_s=1.5,
                              waited_s=1.7, where="flush").to_json()
    assert d == ref


# ----------------------------------------------------------------------
# Disk-cache keying: schema version + query hash
# ----------------------------------------------------------------------

def test_cache_version_invalidates_stale_entries(tmp_path, conv):
    space = build_space(conv, dims=("K", "C"), cluster=False)
    key = ms_cache.search_key(conv, space, PES, BW, "edp", 50, "auto", 0)
    # a stale version-2 payload under the same key must NOT be replayed
    ms_cache.store(str(tmp_path), key, {"best_value": 1.0})
    path = os.path.join(str(tmp_path), f"mapsearch-{key}.json")
    with open(path) as f:
        payload = json.load(f)
    assert payload["version"] == ms_cache.CACHE_VERSION
    payload["version"] = 2
    with open(path, "w") as f:
        json.dump(payload, f)
    assert ms_cache.load(str(tmp_path), key) is None
    # current-version entries load fine
    ms_cache.store(str(tmp_path), key, {"best_value": 2.0})
    assert ms_cache.load(str(tmp_path), key)["best_value"] == 2.0


def test_cache_key_carries_schema_and_query_hash(conv):
    space = build_space(conv, dims=("K", "C"), cluster=False)
    base = ms_cache.search_key(conv, space, PES, BW, "edp", 50, "auto",
                               0, extra="q=aaa")
    assert ms_cache.search_key(conv, space, PES, BW, "edp", 50, "auto",
                               0, extra="q=bbb") != base
    # the session feeds the query fingerprint through cache_extra: a
    # result cached under one query never answers a different one
    q1 = Query(Workload.of_layer(conv), Hardware(num_pes=PES),
               SearchSpec(budget=50))
    q2 = dataclasses.replace(q1, tag="other")
    assert q1.fingerprint() != q2.fingerprint()


def test_session_cache_hit_via_query_fingerprint(tmp_path, conv):
    s = Session(cache_dir=str(tmp_path), device="cpu")
    q = Query(Workload.of_layer(conv), Hardware(num_pes=PES, noc_bw=BW),
              SearchSpec(budget=40, block=BLOCK))
    a = s.run(q)
    assert not a.extras["cached"]
    b = s.run(q)
    assert b.extras["cached"]
    assert a.best == b.best and a.top_k == b.top_k
    # a different query (new fingerprint) misses
    q2 = Query(Workload.of_layer(conv), Hardware(num_pes=PES, noc_bw=BW),
               SearchSpec(budget=40, block=BLOCK), tag="different")
    assert not s.run(q2).extras["cached"]
    m = s.metrics()["session"]
    assert m["n_queries"] == 3 and m["result_cache"]["entries"] == 2


# ----------------------------------------------------------------------
# Resilience at the Query boundary
# ----------------------------------------------------------------------

@pytest.fixture
def fast_retry():
    """A session whose installed retry policy does not sleep; restores
    the process default afterwards."""
    yield ResilienceConfig(retry=RetryPolicy(backoff_s=0.0))
    set_default_policy(None)


def test_degrade_answers_through_the_legacy_pipeline(conv, fast_retry):
    """Every gene-pipeline chunk fails (an injected crash outlasting the
    retries, so the chunk loop raises ``DeviceError``): the query is
    answered by the legacy pipeline on the same device, and says so."""
    q = Query.from_json(TEST_QUERIES["search-parity"])
    s = Session(device="cpu", resilience=fast_retry)
    with faultinject.scoped("crash@chunk:0x1000"):
        rep = s.run(q)
    deg = rep.extras["degraded"]
    assert (deg["from"], deg["to"]) == ("gene", "legacy")
    assert deg["error"].startswith("DeviceError")
    assert rep.extras["pipeline"] == "legacy"
    legacy = Session(device="cpu").run(dataclasses.replace(
        q, search=dataclasses.replace(q.search, pipeline="legacy")))
    assert (rep.best, rep.top_k) == (legacy.best, legacy.top_k)
    strict = Session(device="cpu", resilience=dataclasses.replace(
        fast_retry, degrade=False))
    with faultinject.scoped("crash@chunk:0x1000"):
        with pytest.raises(DeviceError):
            strict.run(q)


def test_installed_retry_policy_reaches_the_chunk_loop(fast_retry):
    """``Session(resilience=...)`` installs its retry policy process-wide
    (``set_default_policy``), and the gene chunk loop reads it: two
    crashes are retried away under three attempts, one crash fails the
    query under one."""
    q = Query.from_json(TEST_QUERIES["search-parity"])
    s = Session(device="cpu", resilience=fast_retry)
    with faultinject.scoped("crash@chunk:0x2"):
        rep = s.run(q)
    assert "degraded" not in rep.extras
    once = Session(device="cpu", resilience=ResilienceConfig(
        retry=RetryPolicy(backoff_s=0.0, max_attempts=1), degrade=False))
    with faultinject.scoped("crash@chunk:0"):
        with pytest.raises(DeviceError, match="after 1 attempts"):
            once.run(q)


def test_query_deadline_raises_budget_exceeded(session):
    d = json.loads(json.dumps(TEST_QUERIES["search-parity"]))
    d["search"]["deadline_s"] = 1e-9
    with pytest.raises(BudgetExceeded, match="deadline"):
        session.run(Query.from_json(d))
    d["search"]["deadline_s"] = 600.0
    assert session.run(Query.from_json(d)).best


def test_what_the_port_has_not_yet_raises(conv):
    """``Query.lint`` needs the port's static analysis (ROADMAP queue 1,
    item 8).  The network kinds, ``run_many``, ``submit`` and ``flush``
    are ported (tests below and in tests/test_torch_run_many.py)."""
    q = Query(Workload.of_layer(conv))
    with pytest.raises(NotImplementedError, match="queue 1, item 8"):
        q.lint()


# ----------------------------------------------------------------------
# Network queries, and a batch that isolates its failing query (the
# batch half's parity with the reference: tests/test_torch_run_many.py)
# ----------------------------------------------------------------------

CHAIN = [ta.conv2d("api-t-n1", k=8, c=4, y=12, x=12, r=3, s=3),
         ta.conv2d("api-t-n2", k=12, c=8, y=14, x=14, r=3, s=3),
         ta.fc("api-t-f1", k=16, c=32)]


def test_search_network_parity(session):
    """The legacy entry point is bit-equal to ``Session.run`` on the
    equivalent network query."""
    from repro_torch.netspace import search_network
    hw = Hardware(num_pes=PES, noc_bw=BW, reconfig_latency=100.0)
    q = Query(Workload.of_layers(CHAIN), hw,
              SearchSpec(objective="edp", budget=80, block=BLOCK,
                         frontier_k=3, budget_policy="uniform"))
    rep = session.run(q)
    r = search_network(CHAIN, objective="edp", budget=80, frontier_k=3,
                       block=BLOCK, hw=hw.hwconfig(),
                       build_kwargs={"cluster": True}, device="cpu")
    assert rep.kind == "network"
    assert rep.best["cost"] == r.schedule.cost
    assert rep.best["edp"] == r.schedule.network_edp
    assert [pl["gene"] for pl in rep.best["per_layer"]] == \
        [list(pl["gene"]) for pl in r.schedule.per_layer]
    assert rep.n_evaluated == r.n_evaluated


def test_network_kinds_round_trip_through_json(session):
    hw = Hardware(num_pes=PES, noc_bw=BW)
    spec = SearchSpec(budget=40, block=BLOCK, frontier_k=2,
                      codse_top_k=2)
    for q in (Query(Workload.of_layers(CHAIN), hw, spec),
              Query(Workload.of_layers(CHAIN), Hardware(
                  num_pes=PES, noc_bw=BW, pe_range=(16, 32),
                  bw_range=(4.0, 8.0)), spec)):
        rep = session.run(q)
        assert rep.kind == q.kind
        d = rep.to_json()
        rt = Report.from_json(json.loads(json.dumps(d)))
        assert rt.to_json() == json.loads(json.dumps(d))
        assert rt.kind == rep.kind and rt.extras["n_classes"] == 2


def test_run_many_isolates_a_failing_query(conv, fast_retry):
    """A query whose candidates are all pruned fails the coalesced pass;
    the batch degrades to one query at a time, and that query alone
    answers as an ``error`` report, as the reference's does."""
    good = Query(Workload.of_layer(conv), Hardware(num_pes=PES, noc_bw=BW),
                 SearchSpec(budget=40, block=BLOCK))
    bad = Query(Workload.of_layer(ta.conv2d("api-t-bad", k=8, c=6, y=12,
                                            x=12, r=3, s=3)),
                Hardware(num_pes=PES, noc_bw=BW),
                SearchSpec(budget=40, block=BLOCK, l1_prune_kb=1e-9))
    reps = Session(device="cpu", resilience=fast_retry).run_many([good,
                                                                  bad])
    assert [r.kind for r in reps] == ["layer", "error"]
    err = reps[1].extras["error"]
    ref = japi.Report.from_error(
        japi.Query.from_json(dict(bad.describe(), workload={"op": dict(
            CONV, name="api-t-bad", c=6)})),
        type(err["type"], (Exception,), {"details": err["details"]})(
            err["message"])).to_json()
    fx.compare_reports(reps[1].to_json(), ref)
    assert reps[0].results_json() == \
        Session(device="cpu").run(good).results_json()
    assert err["type"] == "DeviceError"
    assert "search evaluated no mappings" in err["message"]
    strict = Session(device="cpu", resilience=dataclasses.replace(
        fast_retry, degrade=False))
    with pytest.raises(RuntimeError, match="pruning dropped"):
        strict.run_many([good, bad])


# ----------------------------------------------------------------------
# The CLI helpers and the mapsearch CLI
# ----------------------------------------------------------------------

def test_query_flags_build_the_reference_query():
    import argparse
    from repro.launch import query as jcli
    for argv in ([], ["--co-dse", "--quick", "--budget", "300"],
                 ["--objective", "energy", "--joint-genes", "8"]):
        ap, jap = argparse.ArgumentParser(), argparse.ArgumentParser()
        for p, mod in ((ap, cli), (jap, jcli)):
            mod.add_common_args(p)
            p.add_argument("--co-dse", action="store_true")
            p.add_argument("--strategy", default="auto")
            p.add_argument("--joint-genes", type=int, default=0)
        args = ap.parse_args(argv + ["--device", "cpu"])
        jargs = jap.parse_args(argv)
        assert cli.hardware_from_args(args).describe() == \
            jcli.hardware_from_args(jargs).describe()
        assert cli.searchspec_from_args(args).describe() == \
            jcli.searchspec_from_args(jargs).describe()
        s = cli.session_from_args(args)
        assert s.device == "cpu" and s.cache_dir == cli.DEFAULT_CACHE


def test_mapsearch_cli_on_cpu(capsys, tmp_path):
    argv = ["--model", "vgg16", "--layer", "conv13", "--device", "cpu",
            "--budget", "64", "--cache-dir", str(tmp_path), "--co-dse",
            "--top-k", "2", "--metrics"]
    mapsearch.main(argv)
    out = capsys.readouterr().out
    assert "# layer vgg16-conv13" in out and "best edp = " in out
    assert "# Table 3 baselines" in out and "co-DSE" in out
    assert "frontier (" in out and '"counters"' in out
    mapsearch.main(argv)
    assert "(cached)" in capsys.readouterr().out


def test_mapsearch_cli_errors_are_one_line(capsys):
    """A bad hardware point is one line on stderr and exit code 2, for one
    layer and for a multi-layer batch (``--layer all``) alike."""
    for layer in ("all", "0"):
        with pytest.raises(SystemExit) as ei:
            mapsearch.main(["--model", "vgg16", "--layer", layer,
                            "--device", "cpu", "--cache-dir", "",
                            "--pes", "0"])
        assert ei.value.code == 2
        err = capsys.readouterr().err
        assert err.startswith("error: SpecError") and len(
            err.strip().splitlines()) == 1
