"""Port of the mapping search (``repro_torch.mapspace``) against the JAX
package's ``repro.mapspace``: the gene machinery (numpy, copied) against
the reference's own functions, and ``search_impl`` against the committed
fixture ``tests/data/torch_mapsearch_fixture.json``, which
``scripts/make_mapsearch_fixture.py`` makes with the JAX package (and
``test_fixture_is_what_the_script_makes`` remakes in part, so it cannot
go stale).

Tolerance: exhaustive, random and greedy draw their candidates with numpy
in both packages, so the port must evaluate the same mappings and report
the same strategy, counts, best point and top-k points (ties in the
reference's order), with values and feature rows equal to the fixture's
(made with FMA contraction off, see the script).  The genetic strategy
draws its children from a ``torch.Generator`` where the reference uses
``jax.random``: it is held, as the reference's own test holds it, to
determinism under its seed and a best within 2x of the exhaustive best.
Everything runs with ``device="cpu"``; seeded numpy draws only."""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.mapspace as jms  # noqa: E402
from repro.core import tensor_analysis as jta  # noqa: E402
from repro.mapspace.universal import encode_genes as j_encode  # noqa: E402
from repro.mapspace.universal import universal_specs as j_specs  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch import mapspace as tms  # noqa: E402
from repro_torch.core import dnn_models as tdm  # noqa: E402
from repro_torch.core import tensor_analysis as tta  # noqa: E402
from repro_torch.mapspace import cache as tcache  # noqa: E402
from repro_torch.mapspace.search import _gene_children  # noqa: E402
from repro_torch.mapspace import universal as tmu  # noqa: E402
from repro_torch.mapspace.universal import universal_specs  # noqa: E402
from repro_torch.resilience import (RetryPolicy, SweepKilled,  # noqa: E402
                                    faultinject)
from torch_scripts import load_script  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FIXTURE = ROOT / "tests" / "data" / "torch_mapsearch_fixture.json"
SCRIPT = ROOT / "scripts" / "make_mapsearch_fixture.py"

mk = load_script("make_mapsearch_fixture")

CASES = json.loads(FIXTURE.read_text())["cases"]
PES, BW = 48, 12.0


def port_case(name):
    return mk.build_case(CASES[name]["spec"], tta, tdm, tms)


@pytest.fixture(scope="module")
def conv_pair():
    """(reference op, reference space, port op, port space): the reference
    test suite's window-outer + sliding-cluster conv space."""
    jop = jta.conv2d("gene-conv", k=8, c=6, y=12, x=12, r=3, s=3)
    top = interop.layer_from_plain(dataclasses.asdict(jop))
    kw = dict(dims=("K", "C", "Y"), cluster_sizes=(8,), perm_mode="all")
    return jop, jms.build_space(jop, **kw), top, tms.build_space(top, **kw)


# ----------------------------------------------------------------------
# Gene machinery: the port's copy against the reference's functions
# ----------------------------------------------------------------------

def test_space_and_enumeration_match_reference(conv_pair):
    jop, js, top, ts = conv_pair
    assert ts.fingerprint() == js.fingerprint()
    assert (ts.size, ts.n_groups) == (js.size, js.n_groups)
    np.testing.assert_array_equal(tms.enumerate_genes(ts),
                                  jms.enumerate_genes(js))
    np.testing.assert_array_equal(tms.enumerate_genes(ts, 100, 163),
                                  jms.enumerate_genes(js, 100, 163))
    a = tms.sample_genes(ts, np.random.default_rng(7), 50)
    np.testing.assert_array_equal(
        a, jms.sample_genes(js, np.random.default_rng(7), 50))
    fa = tms.flat_index(ts, a)
    np.testing.assert_array_equal(
        tms.sample_genes(ts, np.random.default_rng(8), 50, exclude_flat=fa),
        jms.sample_genes(js, np.random.default_rng(8), 50, exclude_flat=fa))


def test_dedupe_and_budget_pruning_match_reference(conv_pair):
    jop, js, top, ts = conv_pair
    g = jms.enumerate_genes(js)
    rt, bt = tms.dedupe_equivalent_genes(top, ts, g)
    rj, bj = jms.dedupe_equivalent_genes(jop, js, g)
    np.testing.assert_array_equal(rt, rj)
    np.testing.assert_array_equal(bt, bj)
    assert len(rt) < len(g)
    l1t, l2t = tms.buffer_estimates_genes(top, ts, g)
    l1j, l2j = jms.buffer_estimates_genes(jop, js, g)
    np.testing.assert_array_equal(l1t, l1j)
    np.testing.assert_array_equal(l2t, l2j)
    budget = float(np.median(l1j))
    np.testing.assert_array_equal(
        tms.prune_genes_by_budget(top, ts, g, l1_kb=budget),
        jms.prune_genes_by_budget(jop, js, g, l1_kb=budget))


def _assert_same_spec(jspec, tspec):
    """The port's spec is the reference's without ``ext_operand`` (the
    reference's netspace sets it; its mapspace never does)."""
    want = dataclasses.asdict(jspec)
    assert want.pop("ext_operand") is False
    assert dataclasses.asdict(tspec) == want


def test_encode_genes_matches_reference(conv_pair):
    """The operand dicts both evaluators are fed are byte-identical, and
    the port's vectorized encoder equals its per-point one."""
    jop, js, top, ts = conv_pair
    g = jms.sample_genes(js, np.random.default_rng(0), 64)
    is2 = np.array([js.cluster_options[c] is not None for c in g[:, 2]])
    for tspec, jspec, mask in zip(universal_specs(top, ts),
                                  j_specs(jop, js), (~is2, is2)):
        _assert_same_spec(jspec, tspec)
        a = tms.encode_genes(top, ts, g[mask], tspec, num_pes=PES,
                             noc_bw=BW)
        b = j_encode(jop, js, g[mask], jspec, num_pes=PES, noc_bw=BW)
        c = tms.universal.encode_points(
            top, ts, tms.points_from_genes(g[mask]), tspec, num_pes=PES,
            noc_bw=BW)
        assert set(a) == set(b) == set(c)
        for k in b:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            np.testing.assert_array_equal(c[k], b[k], err_msg=k)
    with pytest.raises(ValueError):
        tms.encode_genes(top, ts, g[is2], universal_specs(top, ts)[0],
                         num_pes=PES, noc_bw=BW)


# ----------------------------------------------------------------------
# search_impl against the JAX package's results
# ----------------------------------------------------------------------

def _assert_matches_fixture(r, want):
    assert r.strategy == want["strategy"]
    assert r.n_evaluated == want["n_evaluated"]
    assert r.n_groups == want["n_groups"]
    assert list(r.best_point) == want["best_point"]
    assert r.best_value == want["best_value"]
    assert [list(e["point"]) for e in r.top_k] == \
        [e["point"] for e in want["top_k"]]
    assert [e["value"] for e in r.top_k] == \
        [e["value"] for e in want["top_k"]]
    for got, ref in zip(r.top_k, want["top_k"]):
        assert got["stats"].keys() == ref["stats"].keys()
        for k, v in ref["stats"].items():
            assert got["stats"][k] == pytest.approx(v, rel=1e-6), k


@pytest.mark.parametrize("name", sorted(CASES))
def test_search_matches_reference(name):
    op, space, kw = port_case(name)
    assert (space.size, space.n_groups) == \
        (CASES[name]["space_size"], CASES[name]["space_groups"])
    r = tms.search_impl(op, space=space, device="cpu", **kw)
    _assert_matches_fixture(r, CASES[name]["result"])
    assert r.pipeline == kw.get("pipeline", "gene")


def test_search_entry_point_is_search_impl():
    op, space, kw = port_case("conv/random/gene")
    r = tms.search(op, space=space, device="cpu", **kw)
    _assert_matches_fixture(r, CASES["conv/random/gene"]["result"])


def test_fixture_is_what_the_script_makes(tmp_path):
    """The JAX package, run now through the script, makes the committed
    file's flat and conv/random cases (both pipelines), value for value.
    The other cases are left to ``test_search_matches_reference`` here
    and to ``chip_smoke.py``, which hold the port's search to them; each
    JAX process the script starts spends ~10 s loading and compiling."""
    out = tmp_path / "fixture.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    subprocess.run([sys.executable, str(SCRIPT), "--out", str(out),
                    "--cases", "flat/*", "conv/random/*"],
                   env=env, check=True, capture_output=True, timeout=600)
    made = json.loads(out.read_text())
    committed = json.loads(FIXTURE.read_text())
    names = ["conv/random/gene", "conv/random/legacy",
             "flat/exhaustive/gene", "flat/exhaustive/legacy"]
    assert sorted(made["cases"]) == names
    assert made == dict(committed, cases={n: committed["cases"][n]
                                          for n in names})


def test_genetic_deterministic_and_competitive():
    op, space, kw = port_case("flat/exhaustive/gene")
    kw = dict(kw, strategy="genetic", budget=150, seed=7)
    a = tms.search_impl(op, space=space, device="cpu", **kw)
    b = tms.search_impl(op, space=space, device="cpu", **kw)
    assert a.best_point == b.best_point
    assert a.best_value == b.best_value
    assert [e["point"] for e in a.top_k] == [e["point"] for e in b.top_k]
    assert a.n_evaluated <= 150
    best = CASES["flat/exhaustive/gene"]["result"]["best_value"]
    assert a.best_value <= best * 2.0


def test_genetic_children_follow_the_generator():
    pool = torch.arange(24, dtype=torch.int32).reshape(8, 3) % 4
    ranges = (4, 4, 4)
    c1 = _gene_children(torch.Generator().manual_seed(1), pool,
                        ranges, 16)
    c2 = _gene_children(torch.Generator().manual_seed(1), pool,
                        ranges, 16)
    assert torch.equal(c1, c2) and c1.shape == (16, 3)
    assert c1.dtype == torch.int32
    assert bool(((c1 >= 0) & (c1 < 4)).all())


def test_ckpt_dir_resume_is_bit_identical(tmp_path):
    name = "conv/random/gene"
    op, space, kw = port_case(name)
    kw = dict(kw, block=32)
    ref = tms.search_impl(op, space=space, device="cpu", **kw)
    with faultinject.scoped("kill@chunk:1"):
        with pytest.raises(SweepKilled):
            tms.search_impl(op, space=space, device="cpu",
                            ckpt_dir=str(tmp_path), **kw)
    assert any(f.startswith("sweep-") for f in os.listdir(tmp_path))
    res = tms.search_impl(op, space=space, device="cpu",
                          ckpt_dir=str(tmp_path), **kw)
    assert res.best_point == ref.best_point
    assert res.best_value == ref.best_value
    assert [e["value"] for e in res.top_k] == \
        [e["value"] for e in ref.top_k]
    _assert_matches_fixture(res, CASES[name]["result"])


@pytest.mark.parametrize("name", ["conv/exhaustive/gene",
                                  "conv/greedy/gene"])
def test_two_shards_give_the_same_answer_as_one(monkeypatch, name):
    """The striping of chunks over devices (per-shard row offsets, the
    (value, global index) merge), run with two shards on the CPU: the
    search evaluates the same mappings and gives the fixture's answer."""
    op, space, kw = port_case(name)
    kw = dict(kw, block=32)
    one = tms.search_impl(op, space=space, device="cpu", **kw)
    assert one.n_devices == 1
    monkeypatch.setattr(tmu, "_devices",
                        lambda device, n_devices: [torch.device("cpu")] * 2)
    two = tms.search_impl(op, space=space, device="cpu", **kw)
    assert two.n_devices == 2
    for r in (one, two):
        _assert_matches_fixture(r, CASES[name]["result"])


def test_oom_split_and_retry_give_the_same_answer():
    op, space, kw = port_case("conv/exhaustive/gene")
    g = tms.enumerate_genes(space)[:300]
    ev_kw = dict(objective="edp", k=8, num_pes=PES, noc_bw=BW, block=64,
                 device="cpu")
    ref = tms.evaluate_genes(op, space, g, **ev_kw)
    fast = RetryPolicy(backoff_s=0.0, min_rows=16)
    for fault in ("oom@chunk:2", "crash@chunk:1"):
        with faultinject.scoped(fault):
            ev = tms.evaluate_genes(op, space, g, retry=fast, **ev_kw)
        assert [t["row"] for t in ev.top] == [t["row"] for t in ref.top]
        assert [t["value"] for t in ev.top] == \
            [t["value"] for t in ref.top]
        np.testing.assert_array_equal(ev.vals, ref.vals)
        assert ev.pareto == ref.pareto


def test_search_cache_roundtrip(tmp_path):
    op, space, kw = port_case("conv/greedy/gene")
    a = tms.search_impl(op, space=space, device="cpu",
                        cache_dir=str(tmp_path), **kw)
    assert not a.cached
    b = tms.search_impl(op, space=space, device="cpu",
                        cache_dir=str(tmp_path), **kw)
    assert b.cached
    assert b.best_point == a.best_point and b.best_value == a.best_value
    assert [e["point"] for e in b.top_k] == [e["point"] for e in a.top_k]
    assert b.wall_s == a.wall_s
    assert tcache.cache_stats(str(tmp_path))[0] == 1


def test_search_reports_rates_and_warm_passes():
    op, space, kw = port_case("flat/exhaustive/gene")
    kw = dict(kw, strategy="random", budget=60, seed=0)
    r = tms.search_impl(op, space=space, device="cpu", **kw)
    assert r.pipeline == "gene" and r.n_devices == 1
    assert r.end_to_end_mappings_per_s == pytest.approx(
        r.n_evaluated / (r.wall_s - r.compile_s))
    assert r.elapsed_s >= r.encode_s
    before = tms.compile_count()
    again = tms.search_impl(op, space=space, device="cpu", **kw)
    assert tms.compile_count() == before and again.n_compiles == 0
    assert again.n_steady > 0 and again.mappings_per_s > 0


def test_gene_pipeline_warms_each_family_once():
    op = tta.conv2d("gene-warm", k=8, c=4, y=10, x=10, r=3, s=3)
    space = tms.build_space(op, dims=("K", "C"), cluster_sizes=(4,),
                            perm_mode="all")
    g = tms.sample_genes(space, np.random.default_rng(2), 96)
    kw = dict(objective="edp", k=4, num_pes=32, noc_bw=8.0, block=64,
              device="cpu")
    before = tms.compile_count()
    ev = tms.evaluate_genes(op, space, g, **kw)
    assert tms.compile_count() - before == ev.run.n_compiles == 2
    before = tms.compile_count()
    tms.evaluate_genes(op, space, g[:20], **kw)
    assert tms.compile_count() == before


def test_unknown_objective_and_pipeline_raise():
    op, space, _ = port_case("flat/exhaustive/gene")
    with pytest.raises(ValueError):
        tms.search_impl(op, space=space, objective="area", device="cpu")
    with pytest.raises(ValueError):
        tms.search_impl(op, space=space, pipeline="fast", device="cpu")


def test_conv13_space_is_the_benchmarks():
    op = tdm.vgg16()[12]
    assert op.name == "vgg16-conv13"
    _, space, _ = port_case("conv13/exhaustive")
    assert (space.size, space.n_groups) == (10368, 72)
