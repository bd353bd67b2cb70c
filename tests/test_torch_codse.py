"""Port of the joint mapping x hardware co-DSE (``repro_torch.mapspace.codse``)
against the JAX package's ``repro.mapspace.codse``.

``co_search_impl`` on a small conv layer over a 3 x 3 hardware grid, with
the paper-scale joint sweep (``joint_genes`` > 0) and a Table 3 baseline,
against the reference's: the bests per objective, the merged Pareto
front (the same designs in the same order), the joint sweep's top and
front, and the counts; points exact, values at rtol 1e-6.  The reference
runs in a process of its own with XLA's CPU code generation capped at
AVX (``--xla_cpu_max_isa=AVX``), as ``tests/test_torch_vectorized.py``
runs it, so that no FMA contraction moves its values.  Then the port
alone: a killed ``joint_sweep`` resumes from its checkpoint bit for bit,
and a ``cancel_scope`` deadline trips ``check_cancel`` at the boundaries
of both chunk loops (the design chunks of ``joint_sweep`` and the device
chunks of ``evaluate_genes``).  Everything runs with ``device="cpu"``."""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import mapspace as tms  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core import tensor_analysis as ta  # noqa: E402
from repro_torch.core.dse import DSEConfig  # noqa: E402
from repro_torch.resilience import (BudgetExceeded, SweepCheckpoint,  # noqa: E402
                                    SweepKilled, cancel_scope, faultinject)
from torch_scripts import load_script  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
fx = load_script("make_front_door_fixture")

CONV = dict(name="codse-t", k=8, c=6, y=12, x=12, r=3, s=3)
GRID = dict(pe_range=(16, 32, 64), bw_range=(4.0, 8.0, 16.0))
CO_KW = dict(objective="edp", mapping_budget=80, top_k=3, num_pes=48,
             noc_bw=12.0, seed=0, include_table3=("C-P",), joint_genes=24,
             joint_block=64,
             search_kwargs={"block": 64, "strategy": "random", "top_k": 6})

_REF = r"""
import json, sys
from repro.core import tensor_analysis as ta
from repro.core.dse import DSEConfig
from repro.mapspace.codse import co_search_impl
conv, grid, kw = json.loads(sys.argv[1])
co = co_search_impl(ta.conv2d(**conv), cfg=DSEConfig(**grid), **kw)
print(json.dumps({"best": co.best, "pareto": co.pareto,
                  "n_evaluated": co.n_evaluated,
                  "dse": [label for label, _ in co.dse],
                  "search_top": [list(e["point"]) for e in co.search.top_k],
                  "joint": {"top": co.joint.top, "pareto": co.joint.pareto,
                            "n_valid": co.joint.n_valid,
                            "n_designs": co.joint.n_designs}}, default=list))
"""


def _plain(x):
    return json.loads(json.dumps(x, default=list))


@pytest.fixture(scope="module")
def reference():
    flags = os.environ.get("XLA_FLAGS", "")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"{flags} --xla_cpu_max_isa=AVX".strip(),
               PYTHONPATH=str(ROOT / "src"))
    arg = json.dumps([CONV, GRID, dict(CO_KW, include_table3=list(
        CO_KW["include_table3"]))])
    out = subprocess.run([sys.executable, "-c", _REF, arg], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.splitlines()[-1])


@pytest.fixture(scope="module")
def ported():
    return tms.co_search_impl(ta.conv2d(**CONV), cfg=DSEConfig(**GRID),
                              device="cpu", **CO_KW)


def test_co_search_matches_reference(reference, ported):
    co = ported
    assert [label for label, _ in co.dse] == reference["dse"]
    assert "table3:C-P" in reference["dse"] and len(co.dse) == 4
    assert [list(e["point"]) for e in co.search.top_k] == \
        reference["search_top"]
    assert co.n_evaluated == reference["n_evaluated"] == \
        80 + 4 * 9 + (24 + 3) * 9
    fx.compare(_plain(co.best), reference["best"])
    fx.compare(_plain(co.pareto), reference["pareto"])
    joint = reference["joint"]
    assert (co.joint.n_valid, co.joint.n_designs) == \
        (joint["n_valid"], joint["n_designs"])
    fx.compare(_plain(co.joint.top), joint["top"])
    fx.compare(_plain(co.joint.pareto), joint["pareto"])


def test_co_search_labels_and_bests(ported):
    """Each front point names where it came from: a searched mapping's
    dataflow (``ms:``), a Table 3 baseline or the joint sweep; the EDP
    best is no worse than any single sweep's."""
    assert {p["mapping"].split(":")[0] for p in ported.pareto} <= \
        {"ms", "table3", "joint"}
    assert all(b is not None for b in ported.best.values())
    assert ported.best["edp"]["edp"] <= min(
        r.best("edp")["edp"] for _, r in ported.dse)


def test_hw_grid_and_merged_pareto_follow_run_dse(ported):
    pes, bws = tms.hw_grid(DSEConfig(**GRID))
    assert pes.dtype == np.int64 and bws.dtype == np.float32
    assert list(zip(pes, bws))[:4] == [(16, 4.0), (16, 8.0), (16, 16.0),
                                       (32, 4.0)]
    front = tms.merged_pareto(ported.dse)
    e = [p["energy_pj"] for p in front]
    t = [p["throughput"] for p in front]
    assert e == sorted(e) and t == sorted(t)


def _sweep_case():
    op = ta.conv2d(**CONV)
    space = tms.build_space(op, dims=("K", "C"), cluster=False)
    genes = tms.sample_genes(space, np.random.default_rng(3), 12)
    return op, space, genes


def test_joint_sweep_resumes_from_its_checkpoint_bit_for_bit(tmp_path):
    op, space, genes = _sweep_case()
    kw = dict(objective="edp", k=5, block=32, chunk_designs=24,
              device="cpu")
    cfg = DSEConfig(**GRID)
    ref = tms.joint_sweep(op, space, genes, cfg, **kw)
    ckpt = SweepCheckpoint(str(tmp_path), "joint-test")
    with faultinject.scoped("kill@design-chunk:2"):
        with pytest.raises(SweepKilled):
            tms.joint_sweep(op, space, genes, cfg, ckpt=ckpt, **kw)
    assert os.listdir(tmp_path)
    res = tms.joint_sweep(op, space, genes, cfg,
                          ckpt=SweepCheckpoint(str(tmp_path), "joint-test"),
                          **kw)
    assert res.n_designs == ref.n_designs == 12 * 9
    assert res.n_valid == ref.n_valid
    assert res.top == ref.top and res.pareto == ref.pareto
    assert not os.listdir(tmp_path)     # a finished sweep clears its file


def _cancelled() -> float:
    return sum(obs.metrics().counters("resilience.cancelled_chunks")
               .values())


def test_cancel_scope_trips_both_chunk_loops():
    """An expired deadline trips at the first boundary of each loop; one
    that expires while the first chunk runs (a slow device chunk injected
    there) trips at the loop's next boundary; an ample one trips
    nowhere."""
    op, space, genes = _sweep_case()
    cfg = DSEConfig(**GRID)
    sweep = lambda: tms.joint_sweep(  # noqa: E731
        op, space, genes, cfg, k=5, block=32, chunk_designs=24,
        device="cpu")
    evaluate = lambda: tms.evaluate_genes(  # noqa: E731
        op, space, tms.enumerate_genes(space), num_pes=48, noc_bw=12.0,
        block=16, device="cpu")
    assert len(tms.enumerate_genes(space)) > 32
    for run, site in ((sweep, "design-chunk"), (evaluate, "chunk")):
        n0 = _cancelled()
        with cancel_scope(time.monotonic() - 1.0):
            with pytest.raises(BudgetExceeded,
                               match=f"at {site} boundary"):
                run()
        # the device chunk's fault point runs after its own poll: chunk
        # 0 passes, runs late, and the loop's next boundary trips (a
        # design chunk of 24 designs is one device chunk of block 32)
        with faultinject.scoped("slow@chunk:0:0.3"):
            with cancel_scope(time.monotonic() + 0.1):
                with pytest.raises(BudgetExceeded,
                                   match=f"at {site} boundary"):
                    run()
        assert _cancelled() == n0 + 2
        with cancel_scope(time.monotonic() + 600.0):
            run()
        assert _cancelled() == n0 + 2


def test_co_search_raises_without_a_device_type_it_can_use(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tms.co_search(ta.conv2d(**CONV), cfg=DSEConfig(**GRID),
                      mapping_budget=8)
