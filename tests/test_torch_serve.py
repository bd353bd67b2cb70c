"""Port of the DSE serving tier (``repro_torch.serve``) — one drill for
each drill of ``tests/test_serve.py``, plus the port's own: the single
flush held to the JAX package's answers, the CLIs in subprocesses, the
worker thread on the session's device.

Load-bearing properties (the reference's):

  * every well-formed request reaches a terminal status — a report
    (including ``timeout``/``error`` kinds), an explicit 429/503 shed,
    or a 400 reject — and ``serve.shed + serve.completed ==
    serve.admitted`` holds;
  * admission backpressure (429 + Retry-After), the cost gate, the
    pre-admission speclint;
  * deadlines enforced in the engine (the batch's cancel scope, opened
    on the flush worker) and backstopped in the handler;
  * chaos drills: ``crash@serve-worker``, ``kill@serve-drain`` and
    restart recovery bit-equal to the offline oracle;
  * a single flush answers bit-equal to the offline ``execute_batch`` of
    the same queries, and to the JAX package's answers in
    ``tests/data/torch_serve_fixture.json`` (points identical, values at
    rtol 1e-6, top-k swaps only within 1e-6 ties).

Steadiness under a loaded machine (the suite runs with 6 workers):
flushes fire by batch size, never by a short clock (``max_batch`` is the
number of queries a drill posts, the flush interval 30 s); a deadline
expires through a query-carried ``deadline_s`` or an injected stall at
least 10x its length; polls wait on a condition for up to 30 s; every
drill runs under ``asyncio.wait_for(..., 60)`` and joins the flush worker
with a timeout; nothing signals this process (drains go through
``srv.drain()``, real process death runs in a subprocess).  This file
imports no JAX: the offline oracle is the port's own ``execute_batch``
(held to the JAX package by ``tests/test_torch_run_many.py``) and the
committed fixture.  Everything runs with ``device="cpu"``.
"""
import asyncio
import glob
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch import obs  # noqa: E402
from repro_torch.api import Query, Report, Session  # noqa: E402
from repro_torch.launch import loadgen as loadgen_cli  # noqa: E402
from repro_torch.resilience import (ResilienceConfig, cancel_scope,  # noqa: E402
                                    faultinject, set_default_policy)
from repro_torch.serve import (DSEServer, ServeConfig,  # noqa: E402
                               execute_batch, http_json, http_text,
                               run_loadgen)
from repro_torch.serve import drain as drainmod  # noqa: E402
from repro_torch.serve.drain import pending_path, recovered_path  # noqa: E402
from torch_scripts import load_script  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SCRIPT = ROOT / "scripts" / "make_front_door_fixture.py"
FIXTURE = ROOT / "tests" / "data" / "torch_serve_fixture.json"
fx = load_script("make_front_door_fixture")

DRILL_S = 60.0          # every in-process drill, end to end
POLL_S = 30.0           # every wait on a condition
WINDOW_S = 30.0         # flush interval: batches fire by size, not time


@pytest.fixture(autouse=True)
def _clean_process_state():
    def reset():
        faultinject.clear()
        set_default_policy(None)
        obs.disable_tracing()
        obs.enable_flight_spans(False)
    reset()
    yield
    reset()


def counter(name):
    return obs.metrics().value(name)


def wire_conv(tag, name, *, k=8, c=6, y=10, x=10, objective="edp",
              budget=32, deadline_s=None):
    """A small coalescible conv query in the wire (queries.json) format,
    as ``tests/test_serve.py`` builds it."""
    search = {"objective": objective, "budget": budget, "block": 64,
              "top_k": 4}
    if deadline_s is not None:
        search["deadline_s"] = deadline_s
    return {"tag": tag,
            "workload": {"op": {"type": "conv2d", "name": name,
                                "k": k, "c": c, "y": y, "x": x,
                                "r": 3, "s": 3}},
            "hardware": {"num_pes": 48, "noc_bw": 12.0},
            "search": search}


QUERIES = [wire_conv("a", "sv-a"),
           wire_conv("b", "sv-b", k=12, objective="runtime"),
           wire_conv("c", "sv-c", c=8, objective="energy")]

_SLICE = ("kind", "name", "objective", "strategy", "best", "top_k",
          "pareto", "n_evaluated")


def results_slice(body):
    """The deterministic Report slice out of a wire response body."""
    return {k: body.get(k) for k in _SLICE}


def session(**kw):
    return Session(device="cpu", cache_dir=None, **kw)


def cfg(tmp_path, **kw):
    """A drill's server config: one flush per posted query unless the
    drill says otherwise, no clock trigger, flight dumps in ``tmp_path``."""
    base = dict(port=0, exit_on_kill=False, max_batch=1,
                flush_interval_s=WINDOW_S, default_deadline_s=120.0,
                flight_dir=str(tmp_path / "flight"))
    base.update(kw)
    return ServeConfig(**base)


def serve_test(coro_fn, config, *, sess=None, faults=None, stop=True):
    """Run ``coro_fn(server)`` against a fresh in-process server on an
    ephemeral port, bounded by ``DRILL_S``; the flush worker must be gone
    when it returns."""
    srvs = []

    async def main():
        if faults:
            faultinject.install(faults)
        srv = DSEServer(sess or session(), config)
        srvs.append(srv)
        await srv.start()
        try:
            return await asyncio.wait_for(coro_fn(srv), timeout=DRILL_S)
        finally:
            if stop:
                await srv.stop()
    out = asyncio.run(main())
    worker = srvs[0].coalescer._thread
    worker.join(timeout=POLL_S)
    assert not worker.is_alive(), "the flush worker outlived its server"
    return out


async def until(cond, what="condition"):
    """Wait for ``cond()`` for up to ``POLL_S``."""
    t_end = time.monotonic() + POLL_S
    while not cond():
        assert time.monotonic() < t_end, f"{what} not met in {POLL_S} s"
        await asyncio.sleep(0.02)


async def post(srv, query, timeout=DRILL_S):
    return await http_json("127.0.0.1", srv.port, "POST", "/query",
                           query, timeout=timeout)


async def get(srv, path):
    return await http_json("127.0.0.1", srv.port, "GET", path)


async def raw_post(srv, query, headers=None):
    """One raw exchange returning (status, response headers, body)."""
    reader, writer = await asyncio.open_connection("127.0.0.1", srv.port)
    try:
        payload = json.dumps(query).encode()
        head = ["POST /query HTTP/1.1", "Host: x",
                f"Content-Length: {len(payload)}", "Connection: close"]
        head += [f"{k}: {v}" for k, v in (headers or {}).items()]
        writer.write(("\r\n".join(head) + "\r\n\r\n").encode() + payload)
        await writer.drain()
        raw = await reader.read()
    finally:
        writer.close()
    head_blk, _, body = raw.partition(b"\r\n\r\n")
    lines = head_blk.decode().split("\r\n")
    status = int(lines[0].split(" ")[1])
    hdrs = {}
    for ln in lines[1:]:
        k, _, v = ln.partition(":")
        hdrs[k.strip().lower()] = v.strip()
    return status, hdrs, json.loads(body) if body.strip() else None


def assert_ledger(snap):
    c = snap["counters"]
    assert c.get("serve.shed", 0) + c["serve.completed"] \
        == c["serve.admitted"]


# ----------------------------------------------------------------------
# Basic serving + endpoints + counter invariant
# ----------------------------------------------------------------------

def test_query_roundtrip_and_endpoints(tmp_path):
    async def drill(srv):
        st, body = await post(srv, QUERIES[0])
        assert st == 200
        assert body["kind"] == "layer"
        # the wire body IS Report.to_json — it must round-trip
        rep = Report.from_json(body)
        assert rep.kind == "layer" and rep.best is not None

        st, health = await get(srv, "/healthz")
        assert (st, health["ok"]) == (200, True)
        st, ready = await get(srv, "/readyz")
        assert (st, ready["ready"]) == (200, True)
        # the worker clears its in-flight list just AFTER resolving the
        # answer: wait for the queue to read empty
        await until(lambda: srv.coalescer.depth() == 0, "empty queue")
        st, snap = await get(srv, "/metricsz")
        assert st == 200
        c = snap["counters"]
        for name in ("serve.requests", "serve.admitted",
                     "serve.completed", "serve.flushes"):
            assert c.get(name, 0) >= 1, name
        assert snap["serve"]["ready"] is True
        assert snap["serve"]["queue_depth"] == 0
        assert_ledger(snap)
    serve_test(drill, cfg(tmp_path))


def test_malformed_query_is_400_outside_invariant(tmp_path):
    async def drill(srv):
        admitted0 = counter("serve.admitted")
        bad0 = counter("serve.bad_requests")
        st, body = await post(srv, {"workload": {"op": {"type": "nope"}}})
        assert st == 400
        assert "error" in body
        assert counter("serve.bad_requests") == bad0 + 1
        assert counter("serve.admitted") == admitted0
    serve_test(drill, cfg(tmp_path))


def test_statically_illegal_query_rejected_before_admission(tmp_path):
    """A parseable query that can never produce a result (a searched dim
    the layer lacks) is rejected by the pre-admission speclint — 400 with
    the structured findings, no flush slot burned, the ledger
    untouched."""
    bad = wire_conv("zdim", "sv-zdim")
    bad["search"]["dims"] = ["K", "Z"]

    async def drill(srv):
        admitted0 = counter("serve.admitted")
        rejected0 = counter("serve.speclint_rejected")
        flushes0 = counter("serve.flushes")
        st, body = await post(srv, bad)
        assert st == 400
        assert body["error"]["type"] == "SpecError"
        codes = [f["code"] for f in body["error"]["findings"]]
        assert "SPEC-DIMS" in codes
        assert counter("serve.speclint_rejected") == rejected0 + 1
        assert counter("serve.admitted") == admitted0
        assert counter("serve.flushes") == flushes0
        # a legal query still flows normally afterwards
        st, ok = await post(srv, QUERIES[0])
        assert st == 200 and ok["kind"] == "layer"
    serve_test(drill, cfg(tmp_path))


# ----------------------------------------------------------------------
# Admission control: queue bound and cost bound
# ----------------------------------------------------------------------

def test_full_queue_sheds_429_with_retry_after(tmp_path):
    # the parked request can only end by its 1 s deadline: no flush
    # fires (64 would fill a batch; the window is 30 s), and it stays in
    # the buffer after its backstop answer, so the queue stays full
    c = cfg(tmp_path, max_queue=1, max_batch=64, default_deadline_s=1.0,
            grace_s=0.5)

    async def drill(srv):
        shed0 = counter("serve.shed")
        parked = asyncio.create_task(post(srv, QUERIES[0]))
        await until(lambda: srv.coalescer.depth() == 1, "parked request")
        for q in (QUERIES[1], QUERIES[2]):
            st, body = await post(srv, q)
            assert st == 429
            assert body["error"]["type"] == "overloaded"
            assert body["error"]["reason"] == "queue"
            assert body["error"]["retry_after_s"] >= 1
        # the Retry-After header itself, via one raw exchange
        st, hdrs, body = await raw_post(srv, QUERIES[1])
        assert st == 429
        assert int(hdrs["retry-after"]) >= 1
        # the parked request still terminates (deadline backstop)
        st, body = await parked
        assert st == 200 and body["kind"] == "timeout"
        assert counter("serve.shed") - shed0 == 3
    serve_test(drill, c)


def test_over_cost_query_sheds_with_estimate(tmp_path):
    async def drill(srv):
        st, body = await post(srv, QUERIES[0])   # cost = budget × 1 = 32
        assert st == 429
        err = body["error"]
        assert err["reason"] == "cost"
        assert err["estimated_cost"] > err["max_cost"] == 10.0
    serve_test(drill, cfg(tmp_path, max_cost=10.0))


# ----------------------------------------------------------------------
# Deadlines: cooperative cancellation + handler backstop, never a hang
# ----------------------------------------------------------------------

STALL_S = 8.0           # 40x the drill's 0.2 s deadline


def test_deadline_expiry_returns_timeout_report_not_hang(tmp_path):
    # the query carries its budget: a server default alone bounds only
    # the handler and the queue, since the session's family scope of a
    # batch without per-query budgets is unbounded (the reference's
    # cancel_scope lets an inner None scope lift an outer bound)
    slow = wire_conv("slow", "sv-slow", deadline_s=0.2)
    c = cfg(tmp_path, grace_s=0.3)

    async def drill(srv):
        timeouts0 = counter("serve.timeouts")
        batch_timeouts0 = counter("session.batch_timeouts")
        st, body = await post(srv, slow)
        assert st == 200
        assert body["kind"] == "timeout"
        assert body["timeout"]["deadline_s"] == 0.2
        # the handler's backstop answered while the worker still sits in
        # the injected stall: the flush has not finished
        assert body["timeout"]["where"] == "in-flight"
        assert srv.coalescer.depth() == 1
        assert counter("serve.timeouts") == timeouts0 + 1
        # when the stall ends, the batch's cancel scope — opened on the
        # flush worker's own thread — stops the engine at its first
        # chunk boundary: the session answers the flush with timeouts
        await until(lambda: srv.coalescer.depth() == 0, "stalled flush")
        assert counter("session.batch_timeouts") == batch_timeouts0 + 1
    # the stall sits in the flush path, past the deadline
    serve_test(drill, c, faults=f"slow@serve-flush:0:{STALL_S}")


def test_query_carried_deadline_beats_server_default(tmp_path):
    async def drill(srv):
        st, body = await post(srv, wire_conv("tiny", "sv-tiny",
                                             deadline_s=1e-6))
        assert st == 200 and body["kind"] == "timeout"
        assert body["timeout"]["deadline_s"] == 1e-6
    serve_test(drill, cfg(tmp_path))


def test_main_thread_cancel_scope_does_not_reach_the_worker(tmp_path):
    """Cancel scopes are thread-local: an expired scope around the whole
    server on the event-loop thread leaves the flush worker's batch
    unbounded (its own scope comes from the request's deadline)."""
    async def drill(srv):
        st, body = await post(srv, QUERIES[0])
        assert st == 200 and body["kind"] == "layer"
    with cancel_scope(time.monotonic() - 1.0):
        serve_test(drill, cfg(tmp_path))


# ----------------------------------------------------------------------
# Chaos drills
# ----------------------------------------------------------------------

def test_crash_at_worker_answers_errors_and_survives(tmp_path):
    async def drill(srv):
        errs0 = counter("serve.flush_errors")
        st, body = await post(srv, QUERIES[0])
        assert st == 200 and body["kind"] == "error"
        assert body["error"]["type"] == "InjectedFault"
        # the worker thread survived: the next request serves normally
        st, body = await post(srv, QUERIES[1])
        assert st == 200 and body["kind"] == "layer"
        assert counter("serve.flush_errors") == errs0 + 1
    serve_test(drill, cfg(tmp_path), faults="crash@serve-worker:0")


def test_clean_drain_flushes_and_clears_pending(tmp_path):
    ck = str(tmp_path / "ckpt")
    sess = session(resilience=ResilienceConfig(ckpt_dir=ck))

    async def drill(srv):
        drains0 = counter("serve.drains")
        posts = [asyncio.create_task(post(srv, q)) for q in QUERIES[:2]]
        await until(lambda: srv.coalescer.depth() == 2, "parked requests")
        await srv.drain()
        for t in posts:                   # the final flush answered them
            st, body = await t
            assert st == 200 and body["kind"] == "layer"
        assert not os.path.exists(pending_path(ck))
        assert counter("serve.drains") == drains0 + 1
    serve_test(drill, cfg(tmp_path, max_batch=64), sess=sess, stop=False)


def _oracle(queries):
    """The port's offline ``--file`` path over the same query set."""
    return [json.loads(json.dumps(r.results_json())) for r in
            execute_batch(session(), [Query.from_json(q) for q in queries])]


def test_kill_mid_drain_then_recovery_matches_oracle(tmp_path):
    ck = str(tmp_path / "ckpt")
    sess = session(resilience=ResilienceConfig(
        ckpt_dir=ck, faults="kill@serve-drain:0"))
    # the parked requests can only end by their 1 s deadline: no flush
    # fires before the drain, and the drain dies before its flush
    c = cfg(tmp_path, max_batch=64, default_deadline_s=1.0, grace_s=0.5)

    async def killed_drill(srv):
        posts = [asyncio.create_task(post(srv, q)) for q in QUERIES[:2]]
        await until(lambda: srv.coalescer.depth() == 2, "parked requests")
        await srv.drain()
        # simulated process death: the pending queue is persisted, the
        # parked requests are NOT answered with real reports — the
        # handler backstop gives them terminal timeouts
        assert os.path.exists(pending_path(ck))
        for t in posts:
            st, body = await t
            assert st == 200 and body["kind"] == "timeout"
    serve_test(killed_drill, c, sess=sess, stop=False)
    assert glob.glob(str(tmp_path / "flight" / "flight-*.json"))
    faultinject.clear()

    recovered0 = counter("serve.recovered")
    sess2 = session(resilience=ResilienceConfig(ckpt_dir=ck))

    async def restarted_drill(srv):
        # recovery ran inside start(), before ready
        assert not os.path.exists(pending_path(ck))
        assert counter("serve.recovered") - recovered0 == 2
        st, ready = await get(srv, "/readyz")
        assert (st, ready["ready"]) == (200, True)
    serve_test(restarted_drill, cfg(tmp_path), sess=sess2)

    rec = json.loads(Path(recovered_path(ck)).read_text())["reports"]
    assert _oracle(QUERIES[:2]) == rec


# ----------------------------------------------------------------------
# Coalesced server == offline --file oracle == the JAX package
# ----------------------------------------------------------------------

def test_single_flush_batch_bit_equal_to_offline_oracle(tmp_path):
    # family spaces pad over the distinct shapes of a batch, so the
    # unit of bit-equality is the FLUSH: the batch fires when all three
    # concurrent posts are in
    sess = session()

    async def drill(srv):
        flushes0 = counter("serve.flushes")
        results = await asyncio.gather(*(post(srv, q) for q in QUERIES))
        assert [st for st, _ in results] == [200] * 3
        assert {body["kind"] for _, body in results} == {"layer"}
        assert counter("serve.flushes") - flushes0 == 1
        return {body["name"]: body for _, body in results}
    served = serve_test(drill, cfg(tmp_path, max_batch=len(QUERIES)),
                        sess=sess)

    oracle = execute_batch(session(),
                           [Query.from_json(q) for q in QUERIES])
    for rep in oracle:
        assert json.loads(json.dumps(rep.results_json())) \
            == results_slice(served[rep.name])

    # and the JAX package's answers to the same flush
    case = json.loads(FIXTURE.read_text())["cases"]["serve"]
    assert case["queries"] == QUERIES
    assert [Query.from_json(q).fingerprint() for q in QUERIES] \
        == case["fingerprints"]
    assert fx.batch_stats(sess.last_batch) == case["batch"]
    for want in case["reports"]:
        fx.compare_reports(served[want["name"]], want)


def test_fixture_is_what_the_script_makes(tmp_path):
    """The JAX package, run now through the script (one AVX-capped
    process, ~20 s), makes the committed serve fixture."""
    out = tmp_path / "serve.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    subprocess.run([sys.executable, str(SCRIPT), "--set", "serve",
                    "--out", str(out)],
                   env=env, check=True, capture_output=True, timeout=600)
    assert json.loads(out.read_text()) == json.loads(FIXTURE.read_text())


# ----------------------------------------------------------------------
# Request ids, timing breakdowns, Prometheus exposition, flight recorder
# ----------------------------------------------------------------------

def test_request_id_honored_and_minted(tmp_path):
    async def drill(srv):
        st, hdrs, body = await raw_post(srv, QUERIES[0],
                                        headers={"X-Request-Id": "my-rid"})
        assert st == 200
        assert hdrs["x-request-id"] == "my-rid"
        assert body["timing"]["request_id"] == "my-rid"
        # no inbound id: the server mints one and echoes it
        st, hdrs, body = await raw_post(srv, QUERIES[1])
        assert st == 200
        minted = hdrs["x-request-id"]
        assert minted and body["timing"]["request_id"] == minted
    serve_test(drill, cfg(tmp_path))


def test_report_timing_phases_sum_to_wall(tmp_path):
    async def drill(srv):
        t0 = time.monotonic()
        st, hdrs, body = await raw_post(srv, QUERIES[0],
                                        headers={"X-Request-Id": "tm-1"})
        client_wall = time.monotonic() - t0
        assert st == 200 and body["kind"] == "layer"
        timing = body["timing"]
        phases = timing["phases"]
        assert "queue_wait" in phases and "other" in phases
        # phases sum to the server-measured wall by construction
        assert sum(phases.values()) == pytest.approx(timing["wall_s"],
                                                     abs=1e-4)
        # and the server wall (enqueue -> answer) lies inside the
        # client's (connect -> response)
        assert 0.0 < timing["wall_s"] <= client_wall + 0.05
        for p in phases:
            assert p in obs.PHASE_NAMES
    serve_test(drill, cfg(tmp_path))


def test_metricsz_content_negotiation(tmp_path):
    async def drill(srv):
        st, body = await post(srv, QUERIES[0])
        assert st == 200
        st, snap = await get(srv, "/metricsz")
        assert st == 200 and isinstance(snap, dict)    # JSON default
        assert "counters" in snap
        st, text = await http_text("127.0.0.1", srv.port, "GET",
                                   "/metricsz?format=prometheus")
        assert st == 200
        assert "# TYPE serve_requests counter" in text
        st, text2 = await http_text(
            "127.0.0.1", srv.port, "GET", "/metricsz",
            headers={"Accept": "text/plain"})
        assert st == 200 and "# TYPE" in text2
        # the Prometheus counters agree with the JSON snapshot
        want = snap["counters"].get("serve.requests", 0)
        got = [ln for ln in text.split("\n")
               if ln.startswith("serve_requests ")]
        assert got and float(got[0].split(" ")[1]) >= want
    serve_test(drill, cfg(tmp_path))


def test_slo_histograms_with_exemplar_request_ids(tmp_path):
    async def drill(srv):
        st, hdrs, body = await raw_post(srv, QUERIES[0],
                                        headers={"X-Request-Id": "ex-1"})
        assert st == 200
        st, text = await http_text("127.0.0.1", srv.port, "GET",
                                   "/metricsz?format=prometheus")
        assert "# TYPE serve_latency_s histogram" in text
        assert 'le="+Inf"' in text
        assert 'request_id="ex-1"' in text
        # per-phase histograms ride too
        assert "serve_phase_s_bucket" in text
    serve_test(drill, cfg(tmp_path))


def test_crash_drill_dumps_flight_recorder_with_request_spans(tmp_path):
    fdir = tmp_path / "flight"

    async def drill(srv):
        st, hdrs, body = await raw_post(srv, QUERIES[0],
                                        headers={"X-Request-Id": "cr-1"})
        assert st == 200 and body["kind"] == "error"
        dumps = glob.glob(str(fdir / "flight-*.json"))
        assert dumps, "crash@serve-worker produced no flight dump"
        doc = json.loads(Path(dumps[0]).read_text())
        assert doc["reason"] == "flush-error"
        assert "cr-1" in doc["request_ids"]
        assert doc["environment"]["backend"] == "cpu"
        errors = [e for e in doc["entries"]
                  if e["name"] == "serve-flush-error"]
        assert errors and errors[0]["error"] == "InjectedFault"
        # the failing request's id is attributable in the ring
        assert any("cr-1" in (e.get("rid") or "")
                   for e in doc["entries"])
    serve_test(drill, cfg(tmp_path), faults="crash@serve-worker:0")


def test_sigterm_drain_saves_trace_and_metrics(tmp_path):
    ck = tmp_path / "ckpt"
    sess = session(resilience=ResilienceConfig(ckpt_dir=str(ck)))
    obs.enable_tracing()

    async def drill(srv):
        st, _ = await post(srv, QUERIES[0])
        assert st == 200
        await srv.drain()
        # the observability state a SIGTERM would lose is flushed
        trace = json.loads((ck / "serve-trace.json").read_text())
        names = {e["name"] for e in trace["traceEvents"]}
        assert {"request", "flush", "queue-wait"} <= names
        snap = json.loads((ck / "serve-metrics.json").read_text())
        assert snap["counters"]["serve.completed"] >= 1
        assert snap["serve"]["draining"] is True
    serve_test(drill, cfg(tmp_path), sess=sess, stop=False)


def test_trace_threads_one_request_through_server_and_engine(tmp_path):
    tracer = obs.enable_tracing()

    async def drill(srv):
        st, hdrs, body = await raw_post(srv, QUERIES[0],
                                        headers={"X-Request-Id": "tr-1"})
        assert st == 200 and body["kind"] == "layer"
    serve_test(drill, cfg(tmp_path))
    obs.disable_tracing()

    def rids(ev):
        r = (ev.get("args") or {}).get("rid")
        return r if isinstance(r, list) else [r]
    by_name = {}
    for e in tracer.events():
        if "tr-1" in rids(e):
            by_name.setdefault(e["name"], []).append(e)
    # one rid threads the server span, the queue-wait + flush spans,
    # and the engine leaf spans of its device pass
    assert "request" in by_name
    assert "queue-wait" in by_name
    assert "flush" in by_name
    assert by_name.keys() & {"compile", "dispatch", "device-pass",
                             "encode"}


# ----------------------------------------------------------------------
# Load: N concurrent clients, every request terminal
# ----------------------------------------------------------------------

def test_loadgen_all_requests_terminal(tmp_path):
    # 10 clients: each wave of 10 concurrent requests fills one batch
    c = cfg(tmp_path, max_batch=10)

    async def drill(srv):
        res = await run_loadgen("127.0.0.1", srv.port, QUERIES,
                                clients=10, requests_per_client=2,
                                timeout=DRILL_S)
        return res, srv.metrics()
    res, snap = serve_test(drill, c)
    assert res.n_requests == 20
    assert res.transport_errors == 0
    assert res.n_terminal == 20               # zero unexplained drops
    assert set(res.statuses) <= {200, 429, 503}
    s = res.summary()
    assert s["p99_s"] > 0 and s["queries_per_s"] > 0
    assert_ledger(snap)


# ----------------------------------------------------------------------
# The CLIs, in processes of their own
# ----------------------------------------------------------------------

def _start_cli(tmp_path, *extra):
    """``python -m repro_torch.launch.serve --device cpu`` on an ephemeral
    port; returns the process and the port it printed."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device",
         "cpu", "--cache-dir", "", "--port", "0", "--flight-dir",
         str(tmp_path / "flight"), *extra],
        env=env, cwd=str(tmp_path), stderr=subprocess.PIPE, text=True)
    t_end = time.monotonic() + 120
    lines = []
    while time.monotonic() < t_end:
        line = proc.stderr.readline()
        if not line:
            break
        lines.append(line)
        if "ready on http://" in line:
            return proc, int(line.rsplit(":", 1)[1].split()[0])
    proc.kill()
    proc.wait(timeout=POLL_S)
    raise AssertionError("the server CLI never got ready:\n"
                         + "".join(lines))


def test_serve_and_loadgen_clis_then_sigterm_drains(tmp_path, capsys):
    qfile = tmp_path / "queries.json"
    qfile.write_text(json.dumps({"queries": QUERIES}))
    out = tmp_path / "summary.json"
    proc, port = _start_cli(tmp_path, "--max-batch", "3",
                            "--flush-interval", str(WINDOW_S))
    try:
        loadgen_cli.main(["--port", str(port), "--file", str(qfile),
                          "--clients", "3", "--requests", "2",
                          "--timeout", str(DRILL_S), "--metricsz",
                          "--prometheus", "--out", str(out)])
        printed = json.loads(capsys.readouterr().out)
        summary = json.loads(out.read_text())
        assert printed["n_terminal"] == summary["n_terminal"] == 6
        assert summary["transport_errors"] == 0
        assert summary["kinds"] == {"layer": 6}
        assert summary["server_metrics"]["counters"]["serve.flushes"] == 2
        assert "# TYPE serve_requests counter" in \
            summary["server_prometheus"]
        # SIGTERM to the server process drains it: a clean exit
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=POLL_S) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=POLL_S)
        proc.stderr.close()


def test_serve_cli_dies_at_kill_mid_drain_and_restart_recovers(tmp_path):
    """``kill@serve-drain`` with the CLI's real process death: SIGTERM
    drains, the drain persists the parked queue and dies (exit 17) before
    its flush; recovery on the persisted queue equals the oracle."""
    ck = tmp_path / "ckpt"
    proc, port = _start_cli(tmp_path, "--max-batch", "64",
                            "--flush-interval", str(WINDOW_S),
                            "--checkpoint-dir", str(ck),
                            "--faults", "kill@serve-drain:0")

    async def park_then_terminate():
        posts = [asyncio.create_task(http_json(
            "127.0.0.1", port, "POST", "/query", q, timeout=DRILL_S))
            for q in QUERIES[:2]]
        t_end = time.monotonic() + POLL_S
        while True:
            _, snap = await http_json("127.0.0.1", port, "GET",
                                      "/metricsz")
            if snap["serve"]["queue_depth"] == 2:
                break
            assert time.monotonic() < t_end, "requests never parked"
            await asyncio.sleep(0.05)
        proc.send_signal(signal.SIGTERM)
        # the dead server answers nothing: the connections just close
        return await asyncio.gather(*posts, return_exceptions=True)
    try:
        asyncio.run(asyncio.wait_for(park_then_terminate(), DRILL_S))
        assert proc.wait(timeout=POLL_S) == 17
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=POLL_S)
        proc.stderr.close()
    assert os.path.exists(pending_path(str(ck)))
    assert glob.glob(str(tmp_path / "flight" / "flight-*.json"))
    assert drainmod.recover(session(), str(ck)) == 2
    assert not os.path.exists(pending_path(str(ck)))
    rec = json.loads(Path(recovered_path(str(ck))).read_text())["reports"]
    assert _oracle(QUERIES[:2]) == rec
