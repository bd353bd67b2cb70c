"""Port of the rest of ``repro.obs`` — the Prometheus renderer, the crash
flight recorder and the profiler hook — and of the spans and metrics the
reference's ``core/dse.py`` and ``resilience``/``api`` emit, against the
JAX package's ``repro.obs`` where both can run the same input:

  * ``prometheus_text`` of one snapshot: byte-equal to the reference's;
  * the flight recorder fed the same record sequence: the same entries
    (the wall clock aside) and a dump with the reference's keys; ring
    wrap, request ids, key collisions, span capture, and ``maybe_dump``'s
    single claim under a race (``tests/test_obs_v2.py:133-171``,
    ``tests/test_analysis.py:392``);
  * ``profile_to`` writes a ``torch.profiler`` trace on the CPU, and the
    CLIs' ``--profile-dir``/``--flight-dir``;
  * ``run_dse``'s ``warmup``/``device-pass`` spans and ``dse.*`` metrics,
    ``check_cancel``'s and ``Report.timeout``'s flight records, as the
    reference's.

Everything of the port runs with ``device="cpu"``.
"""
import argparse
import json
import threading
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro import obs as jobs  # noqa: E402
from repro.obs import prom as jprom  # noqa: E402
from repro.obs.flightrec import FlightRecorder as JFlightRecorder  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.obs import prom  # noqa: E402
from repro_torch.obs.flightrec import FlightRecorder  # noqa: E402
from repro_torch.obs.metrics import Metrics  # noqa: E402


@pytest.fixture(autouse=True)
def _clean_process_state():
    yield
    obs.disable_tracing()
    obs.enable_flight_spans(False)


def _fill(met):
    """The same metric history into either package's registry."""
    met.inc("serve.requests", 7)
    met.inc("serve.shed_detail", reason="queue")
    met.inc("serve.shed_detail", 2, reason='co"st\nx')
    met.inc("9bad.name-x", 3)
    met.gauge("serve.queue_depth", 4)
    met.gauge("serve.ewma_flush_s", 0.125, worker="w1")
    for v in (0.5, 1.25, 3.0):
        met.observe("dse.grid_s", v)
    met.observe("serve.batch_size", 2, family="conv:L1")
    for i, v in enumerate((0.004, 0.03, 0.2, 2.5, 40.0)):
        met.observe_bucketed("serve.latency_s", v, kind="layer",
                             exemplar=f"rid-{i}")
    met.observe_bucketed("serve.phase_s", 0.01, phase="queue_wait")


def test_prometheus_text_is_the_reference_text():
    port, ref = Metrics(), jobs.Metrics()
    _fill(port)
    _fill(ref)
    snap = port.snapshot()
    # the same history gives the same snapshot...
    assert json.loads(json.dumps(snap)) \
        == json.loads(json.dumps(ref.snapshot()))
    # ...and the same text, byte for byte, also with a Session.metrics()
    # block beside the registry's
    assert prom.prometheus_text(snap) == jprom.prometheus_text(snap)
    snap["serve"] = {"port": 1, "ready": True}
    text = prom.prometheus_text(snap)
    assert text == jprom.prometheus_text(snap)
    assert text.encode() == jprom.prometheus_text(snap).encode()
    assert "# TYPE serve_latency_s histogram" in text
    assert 'request_id="rid-4"' in text and "_9bad_name_x 3" in text
    assert prom.CONTENT_TYPE == jprom.CONTENT_TYPE


def _record_sequence(rec, request_scope):
    rec.record("event", "warmup")
    with request_scope("rid-9"):
        # span args may collide with structural entry keys
        rec.record("span", "query", kind="layer", name="shadow",
                   t=123, dur_s=0.5)
    with request_scope("rid-a", "rid-b"):
        rec.record("error", "boom", detail="x")
    rec.record("cancel", "chunk", over_s=0.25)


def _timeless(entries):
    return [{k: v for k, v in e.items() if k != "t"} for e in entries]


def test_flight_recorder_entries_and_dump_match_the_reference(tmp_path):
    port, ref = FlightRecorder(capacity=8), JFlightRecorder(capacity=8)
    _record_sequence(port, obs.request_scope)
    _record_sequence(ref, jobs.request_scope)
    assert _timeless(port.entries()) == _timeless(ref.entries())
    (tmp_path / "p").mkdir()
    (tmp_path / "r").mkdir()
    pdoc = json.loads(Path(port.dump(
        str(tmp_path / "p"), "unit-test", device="cpu",
        request_ids=["rid-9"])).read_text())
    rdoc = json.loads(Path(ref.dump(
        str(tmp_path / "r"), "unit-test",
        request_ids=["rid-9"])).read_text())
    assert pdoc.keys() == rdoc.keys()
    assert (pdoc["reason"], pdoc["request_ids"]) \
        == (rdoc["reason"], rdoc["request_ids"])
    assert _timeless(pdoc["entries"]) == _timeless(rdoc["entries"])
    # provenance: the reference's keys, jax/jaxlib replaced by torch/cuda
    want = (set(rdoc["environment"]) - {"jax", "jaxlib"}) | {"torch",
                                                             "cuda"}
    assert set(pdoc["environment"]) == want
    assert pdoc["environment"]["backend"] == "cpu"
    for p in (tmp_path / "p").iterdir():
        assert p.name.startswith("flight-") and p.suffix == ".json"


def test_flight_ring_wraps_keeping_most_recent():
    rec = obs.FlightRecorder(capacity=16)
    for i in range(40):
        rec.record("event", f"e{i}", i=i)
    entries = rec.entries()
    assert len(entries) == 16
    assert [e["seq"] for e in entries] == list(range(24, 40))
    assert entries[-1]["name"] == "e39"


def test_flight_dump_rate_limited(tmp_path):
    rec = obs.FlightRecorder(capacity=8)
    with obs.request_scope("rid-d"):
        rec.record("error", "boom", detail="x")
    path = rec.dump(str(tmp_path), "unit-test", device="cpu",
                    request_ids=["rid-d"])
    doc = json.loads(Path(path).read_text())
    (e,) = [d for d in doc["entries"] if d["name"] == "boom"]
    assert e["rid"] == "rid-d" and e["detail"] == "x"
    # rate-limited variant: an immediate second dump is suppressed
    assert rec.maybe_dump(str(tmp_path), "again", device="cpu") is None


def test_maybe_dump_single_claim_under_race(tmp_path):
    """Of N threads racing past the rate-limit interval, exactly one
    dumps."""
    rec = FlightRecorder(capacity=16)
    rec.record("event", "warmup")
    results, barrier = [], threading.Barrier(8)

    def racer():
        barrier.wait(timeout=30)
        results.append(rec.maybe_dump(str(tmp_path), "storm",
                                      min_interval_s=60.0, device="cpu"))

    threads = [threading.Thread(target=racer) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    paths = [r for r in results if r is not None]
    assert len(results) == 8 and len(paths) == 1
    assert json.loads(Path(paths[0]).read_text())["reason"] == "storm"
    # a second storm inside the interval stays suppressed
    assert rec.maybe_dump(str(tmp_path), "storm", min_interval_s=60.0,
                          device="cpu") is None


def test_flight_span_capture_feeds_ring_when_enabled():
    from repro_torch.obs.trace import NULL_SPAN
    rec = obs.flight_recorder()
    seq0 = rec.entries()[-1]["seq"] if rec.entries() else -1
    assert obs.span("anything") is NULL_SPAN
    obs.enable_flight_spans(True)
    try:
        assert obs.flight_spans_enabled()
        with obs.request_scope("rid-s"):
            with obs.span("device-pass", rows=2):
                pass
            obs.instant("marker", n=1)
    finally:
        obs.enable_flight_spans(False)
    assert obs.span("anything") is NULL_SPAN
    new = [e for e in rec.entries() if e["seq"] > seq0]
    spans = [e for e in new if e["kind"] == "span"
             and e["name"] == "device-pass"]
    assert spans and spans[-1]["rid"] == "rid-s"
    assert spans[-1]["rows"] == 2
    assert [e for e in new if e["kind"] == "event"
            and e["name"] == "marker"]


def test_default_flight_dir_reads_the_ports_own_variable(monkeypatch,
                                                          tmp_path):
    monkeypatch.setenv("REPRO_FLIGHT_DIR", str(tmp_path / "jax"))
    monkeypatch.delenv("REPRO_TORCH_FLIGHT_DIR", raising=False)
    assert obs.default_flight_dir() != str(tmp_path / "jax")
    monkeypatch.setenv("REPRO_TORCH_FLIGHT_DIR", str(tmp_path / "torch"))
    assert obs.default_flight_dir() == str(tmp_path / "torch")


def test_check_cancel_and_timeout_report_write_the_flight_ring():
    import time
    from repro_torch.api import Query, Report
    from repro_torch.resilience import (BudgetExceeded, cancel_scope,
                                        check_cancel)
    rec = obs.flight_recorder()
    seq0 = rec.entries()[-1]["seq"] if rec.entries() else -1
    with cancel_scope(time.monotonic() - 1.0):
        with pytest.raises(BudgetExceeded):
            check_cancel("chunk")
    q = Query.from_json({
        "workload": {"op": {"type": "conv2d", "name": "ob-t", "k": 8,
                            "c": 6, "y": 10, "x": 10, "r": 3, "s": 3}},
        "search": {"objective": "edp", "budget": 32}})
    rep = Report.timeout(q, deadline_s=0.5, waited_s=0.75, where="flush")
    assert rep.kind == "timeout"
    new = [e for e in rec.entries() if e["seq"] > seq0]
    (cancel,) = [e for e in new if e["kind"] == "cancel"]
    assert cancel["name"] == "chunk" and cancel["over_s"] >= 1.0
    (tmo,) = [e for e in new if e["name"] == "timeout-report"]
    assert (tmo["kind"], tmo["where"], tmo["deadline_s"],
            tmo["waited_s"]) == ("event", "flush", 0.5, 0.75)


def test_profile_to_writes_a_trace_on_the_cpu(tmp_path):
    with obs.profile_to(str(tmp_path / "prof")):
        x = torch.randn(64, 64)
        (x @ x).sum().item()
    (trace,) = (tmp_path / "prof").glob("torch-trace-*.json")
    doc = json.loads(trace.read_text())
    names = {e.get("name", "") for e in doc["traceEvents"]}
    assert any("mm" in n for n in names)


def _cli_args(**kw):
    ns = dict(verbose=0, quiet=1, trace=None, metrics=False,
              profile_dir=None, flight_dir=None, device="cpu")
    ns.update(kw)
    return argparse.Namespace(**ns)


def test_obs_scope_dumps_flight_on_crash_only(tmp_path):
    from repro_torch.launch.query import obs_scope
    from repro_torch.resilience import SpecError
    fdir = tmp_path / "flight"
    with pytest.raises(SpecError):            # an expected exit
        with obs_scope(_cli_args(flight_dir=str(fdir))):
            raise SpecError("bad spec", field="budget")
    assert not fdir.exists()
    with pytest.raises(RuntimeError, match="boom"):
        with obs_scope(_cli_args(flight_dir=str(fdir))):
            obs.flight_record("event", "before-crash")
            raise RuntimeError("boom")
    (dump,) = fdir.glob("flight-*.json")
    doc = json.loads(dump.read_text())
    assert doc["reason"] == "cli-crash"
    assert doc["environment"]["backend"] == "cpu"
    assert any(e["name"] == "before-crash" for e in doc["entries"])


def test_query_cli_profile_dir(tmp_path, capsys):
    from repro_torch.launch import query as cli
    cli.main(["--model", "vgg16", "--layer", "12", "--budget", "16",
              "--cache-dir", "", "--device", "cpu", "-q",
              "--profile-dir", str(tmp_path / "prof")])
    assert "best" in capsys.readouterr().out
    assert list((tmp_path / "prof").glob("torch-trace-*.json"))


def test_run_dse_spans_and_metrics_match_the_reference():
    from repro.core import dataflows as jdf
    from repro.core import dnn_models as jzoo
    from repro.core import dse as jdse
    from repro_torch.core import dataflows as tdf
    from repro_torch.core import dnn_models as tzoo
    from repro_torch.core import dse as tdse

    def run(pkg_obs, zoo, df_mod, dse_mod, **kw):
        op = zoo.vgg16()[10]
        cfg = dse_mod.DSEConfig(pe_range=(8, 16, 32), bw_range=(1.0, 2.0))
        met = pkg_obs.metrics()
        d0 = met.value("dse.designs")
        h0 = met.snapshot()["histograms"].get("dse.grid_s",
                                              {"count": 0})["count"]
        tracer = pkg_obs.enable_tracing()
        try:
            r = dse_mod.run_dse(op, df_mod.table3_for_layer("C-P", op),
                                cfg, **kw)
        finally:
            pkg_obs.disable_tracing()
        spans = [(e["name"], e["args"]) for e in tracer.spans()
                 if e["name"] in ("warmup", "device-pass")]
        h = met.snapshot()["histograms"]["dse.grid_s"]
        return (r.n_evaluated, met.value("dse.designs") - d0,
                h["count"] - h0, spans)
    port = run(obs, tzoo, tdf, tdse, device="cpu")
    ref = run(jobs, jzoo, jdf, jdse)
    assert port == ref
    assert port[:3] == (6, 6, 1)
    assert [name for name, _ in port[3]] == ["warmup", "device-pass"]
    assert port[3][1][1] == {"engine": "dse-grid", "op": "vgg16-conv11",
                             "df": port[3][1][1]["df"], "rows": 6}
