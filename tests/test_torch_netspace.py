"""Port of the whole-network schedule search (``repro_torch.netspace``)
against the JAX package's ``repro.netspace``.

  * ``build_netspace``: the same op-classes, unique-layer index, padded
    spaces, gene ranges, shape operands (``ext_row``/``cin_rows``) and
    option-to-candidate maps, on the test chain, vgg16 and resnet50;
  * ``evaluate_rows``/``evaluate_candidates``: the port's shape-as-operand
    evaluator against the reference's on the same rows, runtime, L1 and
    L2 equal, energy and the objective at rtol 1e-6 (the reference's CPU
    executable may contract a multiply and an add of the energy sums into
    one FMA; ROADMAP §3), with dedupe on and off and with per-row
    hardware, on the chain and on a resnet50-shaped pair (a 1x1 and a 3x3
    layer of one op-class); and the port's shape-as-operand evaluator
    equal to its per-op one, bit for bit, on vgg16 and resnet50;
  * the composer's own properties, as the reference's tests hold them: the
    DP against brute force, the genetic composer against the DP, the L2
    budget of fused stacks, the fusion mask, the reconfig-0/no-fusion
    parity with independent per-layer searches;
  * ``search_network`` and ``co_search_network`` against the reference:
    cost, EDP, segments and per-layer genes identical; the co-DSE's
    counts, bests and Pareto front at rtol 1e-6;
  * vgg16's three chip workloads (``netsearch``'s query and its
    ``--co-dse`` query, ``mapsearch --layer all``'s batch) against the JAX
    package's reports in ``tests/data/torch_netsearch_fixture.json``.

Everything runs with ``device="cpu"``."""
import dataclasses
import itertools
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.netspace as jnet  # noqa: E402
from repro.core import dnn_models as jdm  # noqa: E402
from repro.core import tensor_analysis as jta  # noqa: E402
from repro.core.dse import DSEConfig as JDSEConfig  # noqa: E402
from repro.core.performance import HWConfig as JHWConfig  # noqa: E402
from repro.mapspace.space import sample_genes  # noqa: E402
from repro_torch import api, netspace  # noqa: E402
from repro_torch.core import dnn_models as tdm  # noqa: E402
from repro_torch.core import tensor_analysis as ta  # noqa: E402
from repro_torch.core.dse import DSEConfig  # noqa: E402
from repro_torch.core.performance import HWConfig  # noqa: E402
from repro_torch.launch import mapsearch, netsearch  # noqa: E402
from repro_torch.mapspace import search  # noqa: E402
from repro_torch.netspace.search import _out_vols  # noqa: E402
from torch_scripts import load_script  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FIXTURE = ROOT / "tests" / "data" / "torch_netsearch_fixture.json"
fx = load_script("make_front_door_fixture")

PES, BW = 48, 12.0
BLOCK = 64
CPU = "cpu"


def _chain(pkg):
    return [pkg.conv2d("net-c1", k=8, c=4, y=12, x=12, r=3, s=3),
            pkg.conv2d("net-c2", k=12, c=8, y=14, x=14, r=3, s=3),
            pkg.fc("net-f1", k=16, c=32)]


@pytest.fixture(scope="module")
def chain():
    return _chain(ta)


@pytest.fixture(scope="module")
def ns(chain):
    return netspace.build_netspace(chain)


@pytest.fixture(scope="module")
def jns():
    return jnet.build_netspace(_chain(jta))


def _hw(cls):
    return cls(num_pes=PES, noc_bw=BW, noc_latency=2.0,
               reconfig_latency=100.0)


SEARCH_KW = dict(objective="edp", budget=150, num_pes=PES, noc_bw=BW,
                 seed=0, frontier_k=3, fuse=True, reconfig=True,
                 l2_budget_kb=60.0, block=BLOCK)


@pytest.fixture(scope="module")
def searched(chain, ns):
    """One fusion-aware search shared by the composer tests."""
    return netspace.search_network(chain, hw=_hw(HWConfig), netspace=ns,
                                   device=CPU, **SEARCH_KW)


@pytest.fixture(scope="module")
def jsearched(jns):
    return jnet.search_network_impl(_chain(jta), hw=_hw(JHWConfig),
                                    netspace=jns, **SEARCH_KW)


# ----------------------------------------------------------------------
# The network space: numpy on both sides, identical
# ----------------------------------------------------------------------

def _space_sig(sp):
    return (sp.gene_ranges(), tuple(sp.pinned), sp.perms,
            sp.spatial_choices,
            tuple((ax.dim, tuple(ax.sizes), tuple(ax.offsets))
                  for ax in sp.axes),
            tuple(None if c is None else (c.size, c.inner_dim,
                                          str(c.inner_size),
                                          str(c.inner_offset))
                  for c in sp.cluster_options))


def _spec_sig(spec):
    return None if spec is None else dataclasses.astuple(spec)


@pytest.mark.parametrize("model", ["chain", "vgg16", "resnet50"])
def test_build_netspace_matches_the_reference(model):
    if model == "chain":
        mine, ref = netspace.build_netspace(_chain(ta)), \
            jnet.build_netspace(_chain(jta))
    else:
        mine = netspace.build_netspace(tdm.MODELS[model]())
        ref = jnet.build_netspace(jdm.MODELS[model]())
    assert mine.index == ref.index and mine.class_of == ref.class_of
    assert [o.name for o in mine.unique] == [o.name for o in ref.unique]
    assert mine.fusible == ref.fusible
    assert len(mine.classes) == len(ref.classes)
    for a, b in zip(mine.classes, ref.classes):
        assert (a.key, a.dims, a.cluster_dims, a.members, a.rep.name) == \
            (b.key, b.dims, b.cluster_dims, b.members, b.rep.name)
        assert _spec_sig(a.spec1) == _spec_sig(b.spec1)
        assert _spec_sig(a.spec2) == _spec_sig(b.spec2)
        assert a.spec1.ext_operand
    for u in range(len(mine.unique)):
        assert _space_sig(mine.spaces[u]) == _space_sig(ref.spaces[u])
        np.testing.assert_array_equal(mine.ext_row(u), ref.ext_row(u))
        assert mine.ext_row(u).dtype == ref.ext_row(u).dtype
        for x, y in zip(mine.cin_rows(u), ref.cin_rows(u)):
            np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(mine.cand_of_option(u),
                                      ref.cand_of_option(u))


def test_halo_fractions_match_the_reference(ns, jns):
    for u, sp in enumerate(ns.spaces):
        g = sample_genes(jns.spaces[u], np.random.default_rng(u), 40)
        np.testing.assert_array_equal(
            netspace.halo_fractions(ns.unique[u], sp, g),
            jnet.halo_fractions(jns.unique[u], jns.spaces[u], g))


# ----------------------------------------------------------------------
# The shape-as-operand evaluator against the reference's
# ----------------------------------------------------------------------

EXACT_COLS = (0, 2, 3)          # runtime, l1_kb, l2_kb


def _held(mine_vals, mine_cols, ref_vals, ref_cols):
    np.testing.assert_array_equal(mine_cols[:, EXACT_COLS],
                                  ref_cols[:, EXACT_COLS])
    np.testing.assert_allclose(mine_cols[:, 1], ref_cols[:, 1], rtol=1e-6)
    np.testing.assert_allclose(mine_vals, ref_vals, rtol=1e-6)


def _resnet50_pair(zoo):
    """resnet50's conv2_1a (1x1 over 56x56) and conv2_1b (3x3 over 58x58):
    one op-class whose representative, the 1x1 layer, is not the 3x3
    layer's shape."""
    return [op for op in zoo.resnet50()
            if op.name in ("resnet50-conv2_1a", "resnet50-conv2_1b")]


@pytest.mark.parametrize("layers", ["chain", "resnet50-pair"])
def test_evaluate_rows_matches_the_reference(ns, jns, layers):
    """Rows of every layer of one op-class at once, with per-row hardware
    (as the co-DSE and ``run_many`` give it), in both level-count
    families."""
    if layers == "resnet50-pair":
        ns = netspace.build_netspace(_resnet50_pair(tdm))
        jns = jnet.build_netspace(_resnet50_pair(jdm))
        assert len(ns.classes) == 1
    rng = np.random.default_rng(11)
    for cls in ns.classes:
        uid = np.concatenate([np.full(50, u) for u in cls.members])
        genes = np.concatenate([sample_genes(jns.spaces[u], rng, 50)
                                for u in cls.members])
        pes = rng.choice([16, 48, 128], size=len(uid)).astype(np.float32)
        bw = rng.choice([4.0, 12.0, 32.0], size=len(uid)).astype(np.float32)
        kw = dict(objective="edp", num_pes=pes, noc_bw=bw, block=BLOCK)
        v, c = netspace.evaluate_rows(ns, uid, genes, device=CPU, **kw)
        jv, jc = jnet.evaluate_rows(jns, uid, genes, **kw)
        assert v.dtype == c.dtype == np.float64
        _held(v, c, jv, jc)


@pytest.mark.parametrize("dedupe", [True, False])
def test_evaluate_candidates_matches_the_reference(ns, jns, dedupe):
    cand = [sample_genes(sp, np.random.default_rng(7 + u), 60)
            for u, sp in enumerate(jns.spaces)]
    kw = dict(objective="edp", num_pes=PES, noc_bw=BW, block=BLOCK,
              dedupe=dedupe)
    mine = netspace.evaluate_candidates(ns, cand, device=CPU, **kw)
    ref = jnet.evaluate_candidates(jns, cand, **kw)
    for u in range(len(ns.unique)):
        _held(mine.vals[u], mine.cols[u], ref.vals[u], ref.cols[u])
    assert mine.run.n_rows == ref.run.n_rows
    assert mine.run.n_valid == ref.run.n_valid


def test_evaluator_warm_up_budget_per_op_class():
    """≤ 2 warm-up passes per (op-class, level-count) no matter how many
    layers or structure groups; none on repeat."""
    layers = [ta.conv2d("tnb-c1", k=8, c=4, y=10, x=10, r=3, s=3),
              ta.conv2d("tnb-c2", k=6, c=8, y=12, x=12, r=3, s=3),
              ta.conv2d("tnb-c3", k=4, c=4, y=8, x=8, r=3, s=3)]
    ns2 = netspace.build_netspace(layers)
    assert len(ns2.classes) == 1
    cand = [sample_genes(sp, np.random.default_rng(u), 48)
            for u, sp in enumerate(ns2.spaces)]
    kw = dict(objective="edp", num_pes=32, noc_bw=8.0, block=32,
              device=CPU)
    ev = netspace.evaluate_candidates(ns2, cand, **kw)
    assert 1 <= ev.run.n_compiles <= 2
    assert netspace.evaluate_candidates(ns2, cand, **kw).run.n_compiles == 0


# ----------------------------------------------------------------------
# Composer: DP exactness, footprint bounds, genetic fallback
# ----------------------------------------------------------------------

def _brute_force(frontiers, out_vols, fusible, model):
    best = (np.inf, None, None)
    n_b = len(frontiers) - 1
    for choice in itertools.product(*[range(len(f)) for f in frontiers]):
        for fuse in itertools.product((False, True), repeat=n_b):
            c, _, _ = netspace.evaluate_schedule(frontiers, choice, fuse,
                                                 out_vols, fusible, model)
            if c < best[0]:
                best = (c, choice, fuse)
    return best


def test_dp_matches_bruteforce(chain, ns, searched):
    r = searched
    frontiers = [r.frontiers[ns.index[i]] for i in range(ns.n_layers)]
    cost, choice, fuse = _brute_force(frontiers, _out_vols(chain),
                                      ns.fusible, r.model)
    assert np.isfinite(cost)
    assert r.schedule.cost == pytest.approx(cost, rel=1e-9)
    assert tuple(r.schedule.choice) == choice
    assert tuple(r.schedule.fuse) == fuse


def test_genetic_composer_matches_dp(chain, ns, searched):
    r = searched
    frontiers = [r.frontiers[ns.index[i]] for i in range(ns.n_layers)]
    macs = float(sum(op.total_macs for op in chain))
    sched, _ = netspace.compose_genetic(
        frontiers, _out_vols(chain), ns.fusible, r.model,
        [op.name for op in chain], macs, seed=1)
    assert sched.cost == pytest.approx(r.schedule.cost, rel=1e-9)


def test_fused_footprint_respected(chain, ns):
    kw = dict(SEARCH_KW, reconfig=False)
    budget = 40.0
    r = netspace.search_network(chain, netspace=ns, device=CPU,
                                **dict(kw, l2_budget_kb=budget))
    s = r.schedule
    for a, b in s.segments:
        if b > a:
            stack = sum(s.per_layer[i]["l2_kb"] for i in range(a, b + 1))
            assert stack <= budget + 1e-9
    # an infeasible budget degrades to singleton stacks, not a crash
    tiny = netspace.search_network(chain, netspace=ns, device=CPU,
                                   **dict(kw, l2_budget_kb=1e-3))
    assert all(not f for f in tiny.schedule.fuse)


def test_fusible_mask_blocks_fusion(chain):
    ns2 = netspace.build_netspace(chain, fusible=[False, True])
    r = netspace.search_network(chain, netspace=ns2, device=CPU,
                                **dict(SEARCH_KW, l2_budget_kb=None))
    assert r.schedule.fuse[0] is False
    macs = float(sum(op.total_macs for op in chain))
    frontiers = [r.frontiers[ns2.index[i]] for i in range(ns2.n_layers)]
    sched, _ = netspace.compose_genetic(
        frontiers, _out_vols(chain), ns2.fusible, r.model,
        [op.name for op in chain], macs, seed=0)
    assert sched.fuse[0] is False


def test_reconfig_zero_matches_independent_search(chain, ns):
    r = netspace.search_network(chain, objective="edp", budget=150,
                                num_pes=PES, noc_bw=BW, seed=0,
                                strategy="random", fuse=False,
                                reconfig=False, block=BLOCK, netspace=ns,
                                device=CPU)
    assert all(not f for f in r.schedule.fuse)
    total_e = total_r = 0.0
    for i, op in enumerate(chain):
        s = search(op, objective="edp", budget=150, space=ns.space_for(i),
                   num_pes=PES, noc_bw=BW, strategy="random", seed=0,
                   block=BLOCK, device=CPU)
        assert r.schedule.genes[i] == tuple(s.best_point)
        assert r.schedule.per_layer[i]["value"] == \
            pytest.approx(s.best_value, rel=1e-5)
        total_e += s.best_stats["energy_pj"]
        total_r += s.best_stats["runtime"]
    assert r.schedule.energy_pj == pytest.approx(total_e, rel=1e-5)
    assert r.schedule.runtime == pytest.approx(total_r, rel=1e-5)


# ----------------------------------------------------------------------
# The searches against the reference's
# ----------------------------------------------------------------------

def test_search_network_matches_the_reference(searched, jsearched):
    a, b = searched.schedule, jsearched.schedule
    assert a.cost == b.cost and a.network_edp == b.network_edp
    assert a.segments == b.segments and a.genes == b.genes
    assert [pl["gene"] for pl in a.per_layer] == \
        [pl["gene"] for pl in b.per_layer]
    assert (a.choice, a.fuse, a.n_reconfigs) == \
        (b.choice, b.fuse, b.n_reconfigs)
    assert searched.n_evaluated == jsearched.n_evaluated
    assert searched.strategy == jsearched.strategy
    for fa, fb in zip(searched.frontiers, jsearched.frontiers):
        assert [c.gene for c in fa] == [c.gene for c in fb]


def test_adaptive_budget_policy_matches_the_reference(chain, ns, jns):
    kw = dict(objective="edp", budget=120, num_pes=PES, noc_bw=BW,
              frontier_k=3, block=BLOCK, budget_policy="adaptive")
    a = netspace.search_network(chain, netspace=ns, device=CPU, **kw)
    b = jnet.search_network_impl(_chain(jta), netspace=jns, **kw)
    assert a.refined == b.refined and a.refined
    assert a.n_evaluated == b.n_evaluated
    assert a.schedule.genes == b.schedule.genes
    assert a.schedule.cost == pytest.approx(b.schedule.cost, rel=1e-6)


def test_co_search_network_matches_the_reference(chain, ns, jns):
    kw = dict(objective="edp", budget=100, num_pes=32, noc_bw=8.0, seed=0,
              frontier_k=3, block=BLOCK)
    grid = dict(pe_range=(16, 32, 64), bw_range=(4.0, 8.0, 16.0))
    co = netspace.co_search_network(chain, DSEConfig(**grid), netspace=ns,
                                    device=CPU, **kw)
    ref = jnet.co_search_network_impl(_chain(jta), JDSEConfig(**grid),
                                      netspace=jns, **kw)
    assert (co.n_designs, co.n_hw, co.n_valid) == \
        (ref.n_designs, ref.n_hw, ref.n_valid)
    assert co.n_valid > 0 and co.pareto
    fx.compare(json.loads(json.dumps(co.best)),
               json.loads(json.dumps(ref.best)))
    fx.compare(json.loads(json.dumps(co.pareto)),
               json.loads(json.dumps(ref.pareto)))
    fx.compare(json.loads(json.dumps(co.top)),
               json.loads(json.dumps(ref.top)))
    es = [p["energy_pj"] for p in co.pareto]
    assert es == sorted(es)


def test_uniform_baseline_matches_the_reference(chain):
    base = netspace.uniform_baseline(chain, netspace.NetCostModel(
        hw=HWConfig(num_pes=PES, noc_bw=BW, noc_latency=2.0)))
    ref = jnet.uniform_baseline(_chain(jta), jnet.NetCostModel(
        hw=JHWConfig(num_pes=PES, noc_bw=BW, noc_latency=2.0)))
    assert base == ref
    assert netspace.best_uniform(base) == jnet.best_uniform(ref)


# ----------------------------------------------------------------------
# vgg16's chip workloads against the JAX package's reports
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def fixture_cases():
    return json.loads(FIXTURE.read_text())["cases"]


@pytest.fixture(scope="module")
def vgg16_session():
    return api.Session(cache_dir=None, device=CPU)


def test_cli_queries_are_the_fixtures(fixture_cases):
    """The chip workloads are the CLIs' own defaults: the netsearch
    parser's network and ``--co-dse`` queries and the mapsearch CLI's
    ``--layer all`` batch make the fixture's fingerprints."""
    q, co = netsearch.network_queries(netsearch.build_parser().parse_args(
        ["--model", "vgg16", "--co-dse", "--device", CPU]))
    assert q.fingerprint() == fixture_cases["network"]["fingerprint"]
    assert co.fingerprint() == fixture_cases["network_codse"]["fingerprint"]
    assert q.describe() == api.Query.from_json(
        fixture_cases["network"]["query"]).describe()
    args = mapsearch.build_parser().parse_args(
        ["--model", "vgg16", "--layer", "all", "--device", CPU])
    picked = api.select_layers(tdm.MODELS[args.model](), args.layer)
    qs = mapsearch.layer_queries(picked, args)
    case = fixture_cases["run_many"]
    assert [x.fingerprint() for x in qs] == case["fingerprints"]
    assert [x.describe() for x in qs] == case["queries"]
    assert [x.fingerprint() for x in fx.layer_batch(
        fx.NETSEARCH_CASES["run_many"], api, tdm)] == case["fingerprints"]


@pytest.mark.parametrize("name", ["network", "network_codse"])
def test_vgg16_network_queries_match_the_fixture(vgg16_session,
                                                 fixture_cases, name):
    case = fixture_cases[name]
    rep = vgg16_session.run(api.Query.from_json(case["query"]))
    assert rep.kind == name
    assert fx.compare_reports(rep.to_json(), case["report"]) == 0


def test_vgg16_run_many_matches_the_fixture(vgg16_session, fixture_cases):
    case = fixture_cases["run_many"]
    qs = fx.layer_batch(fx.NETSEARCH_CASES["run_many"], api, tdm)
    reps = vgg16_session.run_many(qs)
    batch = dict(vgg16_session.last_batch)
    assert fx.batch_stats(batch) == case["batch"]
    assert batch["n_compiles"] <= batch["n_families"]
    for rep, want in zip(reps, case["reports"]):
        assert rep.coalesced
        fx.compare_reports(rep.to_json(), want)
    seq = vgg16_session.run_many(qs, coalesce=False)
    assert vgg16_session.last_batch["n_compiles"] == 0
    assert [r.results_json() for r in seq] == \
        [r.results_json() for r in reps]


@pytest.mark.parametrize("model", ["vgg16", "resnet50"])
def test_shape_operand_equals_the_per_op_evaluator(model):
    """The layer shape as a float32 operand, with the class's first layer
    as the evaluator's static ``op``, gives every member layer the same
    (runtime, energy, L1, L2) as the per-op universal evaluator, bit for
    bit (the reference holds its own pair at rtol 1e-5)."""
    from repro_torch.core.vectorized import FEATURES
    from repro_torch.mapspace.space import points_from_genes
    from repro_torch.mapspace.universal import evaluate_points_universal
    ns2 = netspace.build_netspace(tdm.MODELS[model]())
    cand = [sample_genes(sp, np.random.default_rng(u), 40)
            for u, sp in enumerate(ns2.spaces)]
    ev = netspace.evaluate_candidates(ns2, cand, objective="edp",
                                      num_pes=256, noc_bw=32.0, block=256,
                                      dedupe=False, device=CPU)
    cols = [FEATURES.index(c) for c in netspace.COLS]
    for u, op in enumerate(ns2.unique):
        feats, _ = evaluate_points_universal(
            op, ns2.spaces[u], points_from_genes(cand[u]), num_pes=256,
            noc_bw=32.0, block=256, device=CPU)
        np.testing.assert_array_equal(ev.cols[u],
                                      feats[:, cols].astype(np.float64))
        np.testing.assert_array_equal(
            ev.vals[u], feats[:, FEATURES.index("edp")].astype(np.float64))
