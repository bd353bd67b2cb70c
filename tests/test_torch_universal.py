"""Port of the universal and reduced evaluators
(``repro_torch.core.vectorized``) against the JAX package's executables,
fed the same operand dicts (``repro.mapspace.universal.encode_genes`` of
seeded gene draws), and of the tuple-point evaluation paths
(``repro_torch.mapspace.batched``) against the port's own faithful engine.

Tolerance: runtime, macs, util, bw_req, l1_kb, l2_kb and throughput equal
to the reference executable; energy_pj and edp within 1e-6 relative (the
host's executable may fuse a multiply and an add of the energy sums into
one FMA, ROADMAP §3; the port rounds them as written).  The reduction
tail's top-k indices (ties included, in the reference's order), Pareto
masks and valid counts are identical.  Everything runs on the CPU."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import repro.mapspace as jms  # noqa: E402
from repro.core import dnn_models as jdm  # noqa: E402
from repro.core import tensor_analysis as jta  # noqa: E402
from repro.core.energy import DEFAULT_AREA_POWER as J_AP  # noqa: E402
from repro.core.vectorized import HWTail as JHWTail  # noqa: E402
from repro.core.vectorized import ReduceSpec as JReduceSpec  # noqa: E402
from repro.core.vectorized import batched_tile_evaluator as j_tile  # noqa: E402
from repro.core.vectorized import universal_evaluator as j_uni  # noqa: E402
from repro.core.vectorized import \
    universal_reduced_evaluator as j_reduced  # noqa: E402
from repro.mapspace.universal import encode_genes as j_encode  # noqa: E402
from repro.mapspace.universal import universal_specs as j_specs  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch import mapspace as tms  # noqa: E402
from repro_torch.core.energy import DEFAULT_AREA_POWER  # noqa: E402
from repro_torch.core.model import analyze  # noqa: E402
from repro_torch.core.performance import HWConfig  # noqa: E402
from repro_torch.core.vectorized import (FEATURES, HWTail,  # noqa: E402
                                         ReduceSpec, UniversalSpec,
                                         batched_tile_evaluator,
                                         universal_evaluator,
                                         universal_reduced_evaluator)
from repro_torch.mapspace.universal import universal_specs  # noqa: E402

PES, BW = 48, 12.0
EXACT = ("runtime", "macs", "l1_kb", "l2_kb", "util", "bw_req",
         "throughput")


def _small_ops():
    return {
        "conv": (jta.conv2d("uni-conv", k=8, c=6, y=12, x=12, r=3, s=3),
                 dict(dims=("K", "C", "Y"), cluster_sizes=(8,),
                      perm_mode="all")),
        "stride": (jta.conv2d("uni-stride", k=4, c=4, y=11, x=11, r=3,
                              s=3, stride=2),
                   dict(dims=("K", "C", "Y"), cluster_sizes=(4,))),
        "fc": (jta.fc("uni-fc", n=4, k=16, c=12),
               dict(dims=("K", "C", "N"), cluster_sizes=(4,),
                    perm_mode="all")),
    }


CASES = ("conv", "vgg16-conv2", "vgg16-fc1")


def _case(name):
    """(reference op, reference space, port op, port space, genes)."""
    if name.startswith("vgg16"):
        jop = next(o for o in jdm.vgg16() if o.name == name)
        kw = {}
    else:
        jop, kw = _small_ops()[name]
    top = interop.layer_from_plain(dataclasses.asdict(jop))
    js, ts = jms.build_space(jop, **kw), tms.build_space(top, **kw)
    g = jms.sample_genes(js, np.random.default_rng(len(name)), 160)
    return jop, js, top, ts, g


def _assert_same_spec(jspec, tspec):
    """The port's spec is the reference's, ``ext_operand`` off (netspace
    sets it; mapspace never does)."""
    assert jspec.ext_operand is False
    assert dataclasses.asdict(tspec) == dataclasses.asdict(jspec)


def _families(jop, js, top, ts, g, **hw):
    """[(reference spec, port spec, operand dict)] per level-count."""
    hw = hw or dict(num_pes=PES, noc_bw=BW)
    is2 = np.array([js.cluster_options[c] is not None for c in g[:, 2]])
    out = []
    for jspec, tspec, mask in zip(j_specs(jop, js), universal_specs(top, ts),
                                  (~is2, is2)):
        if jspec is None or not mask.any():
            continue
        _assert_same_spec(jspec, tspec)
        hw_m = {k: (v[mask] if np.ndim(v) else v) for k, v in hw.items()}
        out.append((jspec, tspec, j_encode(jop, js, g[mask], jspec, **hw_m)))
    return out


def _torch(ops):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in ops.items()}


def _tail_job(variant):
    """(reference spec, port spec, reference and port ReduceSpecs, operand
    dict with 7 padding rows and the ``live`` mask) of one tail variant:
    the conv case with ties (24 + 4 duplicated rows); EDP with the Pareto
    frontier on the 2-level family, or throughput (maximized) with the
    hardware tail and per-row hardware points on the 1-level family."""
    jop, js, top, ts, g = _case("conv")
    g = np.concatenate([g, g[:24], g[5:9]])
    n = g.shape[0]
    if variant == "edp-pareto":
        kw = dict(objective="edp", k=8, pareto=True)
        jr, tr = JReduceSpec(**kw), ReduceSpec(**kw)
        jspec, tspec, ops = _families(jop, js, top, ts, g)[1]
    else:
        rng = np.random.default_rng(3)
        hw = dict(num_pes=rng.choice([16, 48, 256, 1024], n),
                  noc_bw=rng.choice([4.0, 12.0, 64.0], n))
        kw = dict(objective="throughput", maximize=True, k=5, pareto=True,
                  cols=("runtime", "energy_pj"))
        jr = JReduceSpec(hw=JHWTail(J_AP, 16.0, 450.0), **kw)
        tr = ReduceSpec(hw=HWTail(DEFAULT_AREA_POWER, 16.0, 450.0), **kw)
        jspec, tspec, ops = _families(jop, js, top, ts, g, **hw)[0]
    m = len(ops["pes"])
    ops = {k: np.concatenate([v, np.repeat(v[-1:], 7, 0)])
           for k, v in ops.items()}
    ops["live"] = (np.arange(m + 7) < m).astype(np.float32)
    return jop, top, jspec, tspec, jr, tr, ops, m


TAILS = ("edp-pareto", "throughput-hw")


@pytest.fixture(scope="module")
def reference():
    """The reference executables these tests hold the port against, run on
    their inputs: {key: (output, port-side inputs)}.  Each is traced in
    turn and all are compiled side by side (XLA compiles off the GIL)."""
    from concurrent.futures import ThreadPoolExecutor
    jobs = {}
    for name in CASES:
        jop, js, top, ts, g = _case(name)
        for jspec, tspec, ops in _families(jop, js, top, ts, g):
            jobs["features", name, tspec.n_levels] = (
                j_uni(jop, jspec), (_jnp(ops),), (top, tspec, ops))
    for variant in TAILS:
        jop, top, jspec, tspec, jr, tr, ops, m = _tail_job(variant)
        jobs["tail", variant] = (j_reduced(jop, jspec, jr), (_jnp(ops),),
                                 (top, tspec, tr, ops, m))
    jop, js, top, ts, g = _case("conv")
    key = tuple(int(x) for x in g[0, :3])
    jtpl, jslots = jms.group_template(js, key)
    pts = [key + tuple(int(x) for x in row[3:]) for row in g[:40]]
    sizes, offsets = tms.space.point_operands(ts, pts)
    jobs["tile"] = (j_tile(jop, jtpl, jslots, num_pes=PES, noc_bw=BW),
                    (jnp.asarray(sizes), jnp.asarray(offsets)),
                    (top, tms.group_template(ts, key), sizes, offsets))
    lowered = {k: fn.lower(*args) for k, (fn, args, _) in jobs.items()}
    with ThreadPoolExecutor(len(lowered)) as ex:
        compiled = dict(zip(lowered, ex.map(lambda lo: lo.compile(),
                                            lowered.values())))
    return {k: (compiled[k](*args), ctx)
            for k, (_, args, ctx) in jobs.items()}


def _jnp(ops):
    return {k: jnp.asarray(v) for k, v in ops.items()}


@pytest.mark.parametrize("name", CASES)
def test_universal_features_match_reference(reference, name):
    for levels in (1, 2):
        ref, (top, tspec, ops) = reference["features", name, levels]
        ref = np.asarray(ref)
        got = universal_evaluator(top, tspec)(_torch(ops))
        assert got.dtype == torch.float32 and got.shape == ref.shape
        got = got.numpy()
        for i, f in enumerate(FEATURES):
            msg = f"{name} L{levels} {f}"
            if f in EXACT:
                np.testing.assert_array_equal(got[:, i], ref[:, i],
                                              err_msg=msg)
            else:
                np.testing.assert_allclose(got[:, i], ref[:, i], rtol=1e-6,
                                           err_msg=msg)


@pytest.mark.parametrize("variant", TAILS)
def test_reduced_tail_matches_reference(reference, variant):
    ref, (top, tspec, tr, ops, m) = reference["tail", variant]
    got = universal_reduced_evaluator(top, tspec, tr)(_torch(ops))
    assert set(got) == set(ref)
    np.testing.assert_array_equal(got["top_idx"].numpy(),
                                  np.asarray(ref["top_idx"]))
    assert int(got["n_valid"]) == int(ref["n_valid"]) <= m
    for k in ("top_vals", "vals", "pareto_energy", "pareto_thr"):
        if k in ref:
            assert got[k].dtype == torch.float32, k
            np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                       rtol=1e-6, err_msg=k)
    for k in ("top_feats", "cols"):
        if k in ref:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                       rtol=1e-6, err_msg=k)
    np.testing.assert_array_equal(got["pareto_mask"].numpy(),
                                  np.asarray(ref["pareto_mask"]))


def test_reduce_tail_breaks_ties_toward_the_lower_index():
    """Equal objectives keep row order (``lax.top_k``), and a row that is
    not live never reaches the top even with the best value."""
    from repro_torch.core.vectorized import _reduce_tail
    feats = torch.ones(6, len(FEATURES))
    e = FEATURES.index("edp")
    feats[:, e] = torch.tensor([3.0, 1.0, 2.0, 1.0, 0.5, 1.0])
    live = torch.tensor([1, 1, 1, 1, 0, 1], dtype=torch.float32)
    out = _reduce_tail(ReduceSpec("edp", k=4, pareto=False), feats,
                       {"live": live})
    assert out["top_idx"].tolist() == [1, 3, 5, 2]
    assert out["vals"][4] == float("inf")
    assert int(out["n_valid"]) == 5


def test_tile_evaluator_matches_reference(reference):
    ref, (top, (ttpl, tslots), sizes, offsets) = reference["tile"]
    ref = np.asarray(ref)
    got = batched_tile_evaluator(top, ttpl, tslots, num_pes=PES, noc_bw=BW,
                                 device="cpu")(sizes, offsets).numpy()
    np.testing.assert_array_equal(got[:, 0], ref[:, 0])
    np.testing.assert_allclose(got, ref, rtol=1e-6)


@pytest.mark.parametrize("name", ["conv", "stride", "fc"])
def test_universal_matches_port_faithful_engine(name):
    """Every structure group through the two evaluators, against the
    port's own integer engine (the reference's tests, same tolerance),
    strided convolutions and FC layers included."""
    _, _, top, ts, _ = _case(name)
    pts = tms.sample_points(ts, np.random.default_rng(0), 48)
    assert len({ts.group_key(p) for p in pts}) > 6
    feats, _ = tms.evaluate_points(top, ts, pts, num_pes=PES, noc_bw=BW,
                                   block=64, device="cpu")
    hw = HWConfig(num_pes=PES, noc_bw=BW, noc_latency=2.0)
    for i, pt in enumerate(pts):
        s = analyze(top, tms.point_dataflow(ts, pt), hw)
        got = dict(zip(FEATURES, feats[i]))
        assert got["macs"] == float(s.total_macs)
        for k, v in (("runtime", s.runtime), ("energy_pj", s.energy_pj),
                     ("l1_kb", s.l1_req_kb), ("l2_kb", s.l2_req_kb),
                     ("util", s.utilization), ("edp", s.edp)):
            assert got[k] == pytest.approx(float(v), rel=1e-3), (pt, k)


def test_grouped_engine_agrees_with_universal():
    _, _, top, ts, _ = _case("conv")
    pts = tms.sample_points(ts, np.random.default_rng(3), 12)
    kw = dict(num_pes=PES, noc_bw=BW, block=16, device="cpu")
    fu, su = tms.evaluate_points(top, ts, pts, engine="universal", **kw)
    fg, sg = tms.evaluate_points(top, ts, pts, engine="grouped", **kw)
    np.testing.assert_allclose(fu, fg, rtol=1e-5)
    assert su.n_points == sg.n_points == 12
    assert sg.n_groups == len({ts.group_key(p) for p in pts})


def test_multigroup_points_warm_two_evaluators():
    from repro_torch.core import tensor_analysis as tta
    op = tta.conv2d("uni-warm", k=8, c=4, y=10, x=10, r=3, s=3)
    space = tms.build_space(op, dims=("K", "C"), cluster_sizes=(4,),
                            perm_mode="all")
    pts = tms.sample_points(space, np.random.default_rng(1), 64)
    assert len({space.group_key(p) for p in pts}) >= 6
    before = tms.compile_count()
    _, st = tms.evaluate_points(op, space, pts, num_pes=32, noc_bw=8.0,
                                block=64, device="cpu")
    assert tms.compile_count() - before == st.n_compiles == 2
    before = tms.compile_count()
    tms.evaluate_points(op, space, pts[:16], num_pes=32, noc_bw=8.0,
                        block=64, device="cpu")
    assert tms.compile_count() == before


def test_spec_is_static_structure():
    spec = UniversalSpec(dim_names=("K",), axis_dims=("K",), pinned=())
    assert spec.n_levels == 1 and hash(spec) == hash(dataclasses.replace(
        spec))
    assert dataclasses.replace(spec, cluster=(("K", 1, 1),)).n_levels == 2


def test_measure_rate_runs_on_the_cpu():
    _, _, top, ts, _ = _case("conv")
    rate = tms.measure_rate(top, ts, num_pes=PES, noc_bw=BW, block=64,
                            seconds=0.05, device="cpu")
    assert rate > 0
