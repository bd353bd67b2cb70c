"""The port's static analyzers (``repro_torch.analysis``: the concurrency
linter, the graph audit of the universal evaluators, the waivers and the
lint CLI) on the CPU.

  * the port's concurrency linter gives the reference's findings, finding
    for finding, on every source file of both packages and on the
    reference's own fixtures;
  * the port's tree gives exactly its three threaded-module findings, and
    the shipped ``waivers.toml`` leaves no finding unwaived and no waiver
    unused;
  * each ``TORCH-*`` code of the graph audit catches a seeded fault, and a
    clean case gives none;
  * the shipped corpus runs every family and kind, within its op budget,
    and finds only the two waived host-made-tensor sites.

The jaxpr audit of the reference is no oracle (its tests fail under the
installed jax), so the graph audit is held by seeded faults instead.
"""
import json
import os
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro.analysis import concurrency as jconc  # noqa: E402
from repro_torch.analysis import (DEFAULT_WAIVERS,  # noqa: E402
                                  apply_waivers, load_waivers,
                                  run_repo_lint)
from repro_torch.analysis import concurrency, graph_audit  # noqa: E402
from repro_torch.analysis.graph_audit import (FamilyCase,  # noqa: E402
                                              audit_case)
from repro_torch.api import Report  # noqa: E402
from repro_torch.launch import lint  # noqa: E402

SRC = Path(repro_torch.__file__).resolve().parents[1]

CONC_FINDINGS = {
    ("CONC-UNLOCKED", "obs/flightrec.py::FlightRecorder.record"),
    ("CONC-GLOBAL", "obs/flightrec.py::enable_flight_spans"),
    ("CONC-GLOBAL", "obs/trace.py::enable_tracing"),
}
H2D_SITES = {"core/cluster_analysis.py::_scalar_tensor",
             "core/vectorized.py::_reduce_tail"}
KINDS = ("plain", "reduced", "codse", "netspace")


# ----------------------------------------------------------------------
# Concurrency: finding for finding with the reference
# ----------------------------------------------------------------------

_BROKEN_COUNTER = textwrap.dedent("""\
    import threading

    class Ring:
        def __init__(self):
            self._lock = threading.Lock()
            self._items = []
            self._count = 0

        def locked_add(self, x):
            with self._lock:
                self._items.append(x)
                self._count += 1

        def racy_add(self, x):
            self._items.append(x)
            self._count += 1
""")

_CTX = textwrap.dedent("""\
    import threading
    from contextvars import ContextVar

    CURRENT = ContextVar("current")
    TOTAL = 0

    def bump():
        global TOTAL
        TOTAL += 1

    def set_and_leak(v):
        CURRENT.set(v)

    def set_and_reset(v):
        tok = CURRENT.set(v)
        CURRENT.reset(tok)

    def per_call_local():
        tls = threading.local()
        return tls
""")


def _rows(findings):
    return sorted((f.code, f.severity, f.site, f.where, f.message)
                  for f in findings)


def _sources(pkg: str):
    root = SRC / pkg
    for path in sorted(root.rglob("*.py")):
        yield path.relative_to(root).as_posix(), path.read_text()


@pytest.mark.parametrize("corpus", ["repro", "repro_torch", "ring",
                                    "ring-unshared", "ctx"])
def test_concurrency_matches_reference(corpus):
    if corpus in ("repro", "repro_torch"):
        sources = list(_sources(corpus))
        assert len(sources) > 50
        for rel, src in sources:
            got = concurrency.lint_source(src, rel,
                                          concurrency.THREADED.get(rel))
            want = jconc.lint_source(src, rel, jconc.THREADED.get(rel))
            assert _rows(got) == _rows(want), rel
        return
    src = _CTX if corpus == "ctx" else _BROKEN_COUNTER
    unshared = {"Ring": "externally locked"} \
        if corpus == "ring-unshared" else {}
    got = concurrency.lint_source(src, f"fix/{corpus}.py",
                                  concurrency.ModulePolicy(unshared))
    want = jconc.lint_source(src, f"fix/{corpus}.py",
                             jconc.ModulePolicy(unshared))
    assert _rows(got) == _rows(want)
    sites = {(f.code, f.site) for f in got}
    if corpus == "ring":
        assert ("CONC-UNLOCKED", "fix/ring.py::Ring.racy_add") in sites
        assert all("locked_add" not in f.site for f in got)
    elif corpus == "ctx":
        assert sites == {("CONC-GLOBAL", "fix/ctx.py::bump"),
                         ("CONC-CONTEXTVAR", "fix/ctx.py::set_and_leak"),
                         ("CONC-THREADLOCAL",
                          "fix/ctx.py::per_call_local")}
    else:
        assert got == []


def test_threaded_registry_is_the_references():
    assert set(concurrency.THREADED) == set(jconc.THREADED)
    for rel, policy in concurrency.THREADED.items():
        assert (SRC / "repro_torch" / rel).is_file(), rel
        assert policy.unshared == jconc.THREADED[rel].unshared, rel


def test_port_tree_findings_and_shipped_waivers(cpu_audit):
    got = concurrency.lint_tree()
    assert {(f.code, f.site) for f in got} == CONC_FINDINGS
    assert len(got) == len(CONC_FINDINGS)
    findings = run_repo_lint() + cpu_audit[0]
    assert sorted(map(repr, got)) == sorted(
        repr(f) for f in findings if f.analyzer == "concurrency")
    unwaived, waived, unused = apply_waivers(findings, load_waivers())
    assert unwaived == [], [f.one_line() for f in unwaived]
    assert unused == [], [f"{w.code} @ {w.site}" for w in unused]
    assert {(f.code, f.site) for f in waived} == CONC_FINDINGS | {
        ("TORCH-H2D", s) for s in H2D_SITES}


# ----------------------------------------------------------------------
# Graph audit: seeded faults
# ----------------------------------------------------------------------

def _x():
    return np.linspace(-1, 1, 64, dtype=np.float32)


def f64_upcast(o):
    return o["x"].double() * 2.0


def widen_index(o):
    return o["i"].to(torch.int64) + 1


def read_item(o):
    return o["x"] * o["x"].sum().item()


def mask_select(o):
    return o["x"][o["x"] > 0]


def host_scalar(o):
    return o["x"] + torch.tensor(2.0, device=o["x"].device)


def sum_used(o):
    return o["used"].sum()


def double_it(o):
    return o["x"] * 2.0


def many_sines(o):
    x = o["x"]
    for _ in range(40):
        x = torch.sin(x) + 1.0
    return x


def reduce_clean(o):
    return {"s": o["x"].sum(), "m": o["x"].amax()}


FAULTS = {
    "TORCH-TRACE": (lambda o: o["missing-key"], {"x": _x()}, "plain"),
    "TORCH-F64": (f64_upcast, {"x": _x()}, "plain"),
    "TORCH-WIDEN": (widen_index, {"i": np.arange(8, dtype=np.int32)},
                    "plain"),
    "TORCH-SYNC": (read_item, {"x": _x()}, "plain"),
    "TORCH-SYNC/mask": (mask_select, {"x": _x()}, "plain"),
    "TORCH-H2D": (host_scalar, {"x": _x()}, "plain"),
    "TORCH-UNUSED": (sum_used, {"used": _x(), "ignored": _x()}, "plain"),
    "TORCH-SHRINK": (double_it, {"x": _x()}, "reduced"),
    "TORCH-OPBUDGET": (many_sines, {"x": _x()}, "plain"),
    "clean": (reduce_clean, {"x": _x()}, "reduced"),
}


def _case(fn, ops, kind, **kw):
    return FamilyCase(name="fix:L1/x", family="fix:L1", fn=fn, ops=ops,
                      kind=kind, **kw)


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_graph_audit_catches_seeded_fault(fault, monkeypatch):
    fn, ops, kind = FAULTS[fault]
    code = fault.split("/")[0]
    if code == "TORCH-OPBUDGET":
        monkeypatch.setitem(graph_audit.OP_BUDGET, "fix:L1", 10)
    fs, rec = audit_case(_case(fn, ops, kind), "cpu")
    codes = {f.code for f in fs}
    if code == "clean":
        assert fs == [] and 0 < rec["aten_ops"] <= rec["budget"]
        return
    assert code in codes, [f.one_line() for f in fs]
    here = os.path.basename(__file__)
    if code == "TORCH-TRACE":
        assert [f.code for f in fs] == ["TORCH-TRACE"]
        assert rec["aten_ops"] == 0
    elif code == "TORCH-F64":
        assert codes == {"TORCH-F64", "TORCH-WIDEN"}
    elif code == "TORCH-WIDEN":
        assert codes == {"TORCH-WIDEN"}     # int64 alone is no finding
        assert "int32 -> int64" in fs[0].message
    elif code == "TORCH-SYNC":
        sync = [f for f in fs if f.code == code]
        assert [f.site for f in sync] == [f"{here}::{fn.__name__}"]
        assert ("_local_scalar_dense" in sync[0].message
                or "bool mask" in sync[0].message)
    elif code == "TORCH-H2D":
        assert [(f.code, f.site) for f in fs] == [
            ("TORCH-H2D", f"{here}::host_scalar")]
        assert rec["host_made"] == {f"{here}::host_scalar": 1}
    elif code == "TORCH-UNUSED":
        assert len(fs) == 1 and "'ignored'" in fs[0].message
        tolerant = _case(fn, ops, kind, allow_unused=("ignored",))
        assert audit_case(tolerant, "cpu")[0] == []
    elif code == "TORCH-OPBUDGET":
        assert rec["aten_ops"] > 10


# ----------------------------------------------------------------------
# Graph audit: the shipped corpus on the CPU
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def cpu_audit():
    return graph_audit.audit("cpu")


def test_shipped_corpus_on_cpu(cpu_audit):
    findings, report = cpu_audit
    fams = set(graph_audit.OP_BUDGET)
    assert set(report["cases"]) == {f"{fam}/{k}" for fam in fams
                                    for k in KINDS}
    assert report["device"] == "cpu" and report["n_cases"] == 16
    assert {(f.code, f.site) for f in findings} == {
        ("TORCH-H2D", s) for s in H2D_SITES}
    for name, rec in report["cases"].items():
        assert 0 < rec["aten_ops"] <= graph_audit.OP_BUDGET[rec["family"]]
        assert rec["budget"] == graph_audit.OP_BUDGET[rec["family"]]
        assert set(rec["host_made"]) <= H2D_SITES, name
        assert rec["host_made"]["core/cluster_analysis.py::_scalar_tensor"]
    unwaived, _, _ = apply_waivers(findings, load_waivers())
    assert unwaived == []


# ----------------------------------------------------------------------
# The CLI
# ----------------------------------------------------------------------

@pytest.fixture
def no_cuda(monkeypatch):
    """A CPU-only machine, whatever this one has."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_cli_json_round_trip(cpu_audit, monkeypatch, tmp_path, capsys):
    # the audit itself is held by test_shipped_corpus_on_cpu
    monkeypatch.setattr(graph_audit, "audit",
                        lambda device=None: cpu_audit)
    out = tmp_path / "lint.json"
    assert lint.main(["--device", "cpu", "--json", "--out",
                      str(out)]) == 0
    doc = json.loads(out.read_text())
    assert json.loads(capsys.readouterr().out) == doc
    rep = Report.from_json(doc)
    assert rep.kind == "bench" and rep.name == "lint"
    assert rep.extras["n_unwaived"] == 0 and rep.extras["n_findings"] == 5
    assert rep.extras["unused_waivers"] == []
    assert {(f["code"], f["site"]) for f in rep.extras["waived"]} == \
        CONC_FINDINGS | {("TORCH-H2D", s) for s in H2D_SITES}
    assert rep.extras["audit"]["n_cases"] == 16
    assert rep.extras["environment"]["backend"] == "cpu"


def test_cli_unused_waiver_fails(tmp_path, capsys):
    shipped = Path(DEFAULT_WAIVERS).read_text()
    stale = tmp_path / "stale.toml"
    stale.write_text(shipped + textwrap.dedent("""
        [[waiver]]
        code = "CONC-GLOBAL"
        site = "nowhere.py::gone"
        reason = "the code was fixed"
    """))
    assert lint.main(["--device", "cpu", "--no-audit", "--waivers",
                      str(stale)]) == 1
    assert "unused waiver: CONC-GLOBAL @ nowhere.py::gone" in \
        capsys.readouterr().err


def test_cli_and_audit_default_to_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lint.main(["--no-audit"])
    with pytest.raises(RuntimeError):
        graph_audit.audit()
    with pytest.raises(RuntimeError):
        audit_case(_case(double_it, {"x": _x()}, "plain"))
