"""Port of the static legality lint (``repro_torch.analysis.speclint``,
``findings``) and of ``Query.lint``, against the JAX package's
``repro.analysis``: the same findings — code, severity, site, message —
on ``tests/test_analysis.py``'s fixtures (the directive programs of its
lines 149-200 and the queries of 202-213), on the shipped dataflow
corpus, on every layer of the zoo's models, and on
``examples/queries.json``; ``Query.lint`` raises the same ``SpecError``
with the findings attached.  The lint builds no tensor, so nothing here
needs a device."""
import json
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro.analysis import findings as jfindings  # noqa: E402
from repro.analysis import speclint as jlint  # noqa: E402
from repro.api import Query as JQuery  # noqa: E402
from repro.core import directives as jd  # noqa: E402
from repro.core import dnn_models as jzoo  # noqa: E402
from repro.core.tensor_analysis import conv2d as jconv2d  # noqa: E402
from repro.resilience.errors import SpecError as JSpecError  # noqa: E402
from repro_torch.analysis import (CODES, Finding, Waiver,  # noqa: E402
                                  apply_waivers, load_waivers,
                                  run_repo_lint, speclint)
from repro_torch.api import Query  # noqa: E402
from repro_torch.core import directives as td  # noqa: E402
from repro_torch.core import dnn_models as tzoo  # noqa: E402
from repro_torch.core.tensor_analysis import conv2d  # noqa: E402
from repro_torch.resilience.errors import SpecError  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

CONV = dict(k=64, c=64, y=28, x=28, r=3, s=3)

# tests/test_analysis.py's directive-program fixtures, as
# (name, [(directive, size, offset, dim) or ("Cluster", size)], num_pes)
PROGRAMS = [
    ("bad-tile", [("TemporalMap", 5, 5, "K"), ("SpatialMap", 1, 1, "C")],
     None),
    ("win", [("TemporalMap", 10, 8, "X"), ("SpatialMap", 1, 1, "K")],
     None),
    ("c-empty", [("SpatialMap", 1, 1, "K"), ("Cluster", 8)], None),
    ("c-big", [("SpatialMap", 1, 1, "K"), ("Cluster", 64),
               ("SpatialMap", 1, 1, "C")], 16),
    ("sp", [("SpatialMap", 2, 2, "Y"), ("SpatialMap", 3, 3, "R")], None),
    ("over", [("TemporalMap", 100, 100, "K")], None),
    ("ok", [("SpatialMap", 1, 1, "K"), ("TemporalMap", 2, 2, "C")], None),
]
TEXTS = ["TemporalMap(2,2) K\nTemporalMap(3,3) K",
         "SpatialMap(1,1) K\nTemporalMap(2,2) C",
         "SpatialMap(1,1) K\nCluster(4)\nSpatialMap(1,1) C",
         "NotADirective(1,1) K"]


def _program(mod, name, spec):
    ds = []
    for d in spec:
        if d[0] == "Cluster":
            ds.append(mod.Cluster(d[1]))
        else:
            ds.append(getattr(mod, d[0])(d[1], d[2], d[3]))
    return mod.Dataflow(name, tuple(ds))


def _json(findings):
    return [f.to_json() for f in findings]


@pytest.mark.parametrize("name,spec,num_pes", PROGRAMS,
                         ids=[p[0] for p in PROGRAMS])
def test_lint_dataflow_matches_reference(name, spec, num_pes):
    got = speclint.lint_dataflow(_program(td, name, spec),
                                 conv2d("an-conv", **CONV),
                                 num_pes=num_pes)
    want = jlint.lint_dataflow(_program(jd, name, spec),
                               jconv2d("an-conv", **CONV),
                               num_pes=num_pes)
    assert _json(got) == _json(want)


def test_fixture_codes_are_the_reference_tests():
    """The codes tests/test_analysis.py asserts on the same programs."""
    op = conv2d("an-conv", **CONV)
    codes = {name: [(f.code, f.severity) for f in speclint.lint_dataflow(
        _program(td, name, spec), op, num_pes=pes)]
        for name, spec, pes in PROGRAMS}
    assert codes == {
        "bad-tile": [("SPEC-TILE", "warn")], "win": [],
        "c-empty": [("SPEC-CLUSTER", "error")],
        "c-big": [("SPEC-CLUSTER", "error")],
        "sp": [("SPEC-SPATIAL", "error")],
        # a size and an offset over the extent: one warning each
        "over": [("SPEC-ILLEGAL", "warn")] * 2, "ok": []}


@pytest.mark.parametrize("text", TEXTS)
def test_lint_text_matches_reference(text):
    got = speclint.lint_text(text, conv2d("an-conv", **CONV))
    want = jlint.lint_text(text, jconv2d("an-conv", **CONV))
    assert _json(got) == _json(want)


def test_shipped_corpus_is_clean_in_both():
    assert speclint.lint_corpus() == [] == jlint.lint_corpus()
    assert run_repo_lint() == []


@pytest.mark.parametrize("model", sorted(tzoo.MODELS))
def test_zoo_layers_lint_as_the_reference(model):
    """Every Table-3 dataflow on every layer of a zoo model."""
    from repro.core import dataflows as jdf
    from repro_torch.core import dataflows as tdf
    got, want = [], []
    for top, jop in zip(tzoo.MODELS[model](), jzoo.MODELS[model]()):
        for name in tdf.TABLE3:
            got += _json(speclint.lint_dataflow(
                tdf.table3_for_layer(name, top), top, num_pes=256))
            want += _json(jlint.lint_dataflow(
                jdf.table3_for_layer(name, jop), jop, num_pes=256))
    assert got == want


def _query_json(**search):
    return {"workload": {"op": {"type": "conv2d", "name": "an-q", **CONV}},
            "hardware": {"num_pes": 48},
            "search": {"objective": "edp", **search}}


QUERY_CASES = {
    "bad-dims": {"dims": ["K", "Z"]},
    "l1-budget": {"l1_prune_kb": 0.001},
    "l2-budget": {"l2_prune_kb": 0.001},
    "both-budgets": {"l1_prune_kb": 0.001, "l2_prune_kb": 0.001},
    "legal": {},
    "dims-kc": {"dims": ["K", "C"]},
}


@pytest.mark.parametrize("case", sorted(QUERY_CASES))
def test_lint_query_matches_reference(case):
    d = _query_json(**QUERY_CASES[case])
    got = speclint.lint_query(Query.from_json(d))
    want = jlint.lint_query(JQuery.from_json(d))
    assert _json(got) == _json(want)
    assert _json(speclint.errors_only(got)) \
        == _json(jlint.errors_only(want))


def test_examples_queries_lint_as_the_reference():
    doc = json.loads((ROOT / "examples" / "queries.json").read_text())
    for d in doc["queries"]:
        got = speclint.lint_query(Query.from_json(d))
        want = jlint.lint_query(JQuery.from_json(d))
        assert _json(got) == _json(want), d.get("tag")
        Query.from_json(d).lint()          # the shipped batch is legal


def test_query_lint_raises_specerror_with_the_reference_findings():
    d = _query_json(dims=["K", "Z"])
    with pytest.raises(SpecError) as got:
        Query.from_json(d).lint()
    with pytest.raises(JSpecError) as want:
        JQuery.from_json(d).lint()
    assert got.value.details == want.value.details
    assert str(got.value) == str(want.value)
    assert got.value.details["findings"][0]["code"] == "SPEC-DIMS"
    Query.from_json(_query_json()).lint()  # legal query: no raise


def test_finding_and_waiver_schema_match_the_reference():
    assert set(CODES) == {c for c in jfindings.CODES
                          if not c.startswith("JAX-")}
    f = Finding(code="SPEC-TILE", site="x.py::f", message="m",
                severity="warn")
    assert f.one_line() == jfindings.Finding(
        code="SPEC-TILE", site="x.py::f", message="m",
        severity="warn").one_line()
    for bad in (dict(code="NOT-A-CODE", site="s", message="m"),
                dict(code="SPEC-TILE", site="s", message="m",
                     severity="meh")):
        with pytest.raises(ValueError):
            Finding(**bad)
    with pytest.raises(ValueError):
        Waiver(code="SPEC-TILE", site="s", reason="")
    f1 = Finding(code="CONC-GLOBAL", site="a.py::f", message="m")
    f2 = Finding(code="CONC-GLOBAL", site="b.py::g", message="m")
    w_used = Waiver(code="CONC-GLOBAL", site="a.py::f", reason="ok")
    w_unused = Waiver(code="CONC-UNLOCKED", site="zz.py::h", reason="ok")
    unwaived, waived, unused = apply_waivers([f1, f2], [w_used, w_unused])
    assert [f.site for f in unwaived] == ["b.py::g"]
    assert [f.site for f in waived] == ["a.py::f"]
    assert unused == [w_unused]
    assert load_waivers() == []            # the port ships none yet
