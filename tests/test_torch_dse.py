"""Port of the hardware DSE (``repro_torch.core.dse``) against the JAX
package's ``run_dse_full`` on ``tests/test_system.py``'s configuration:
identical valid masks, n_valid and best designs; values within rtol 1e-6
(the float32 feature tolerance of the batched evaluator; area and power
are computed on the host in numpy from equal inputs)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import tensor_analysis as jta  # noqa: E402
from repro.core.dse import DSEConfig as JCfg  # noqa: E402
from repro.core.dse import merge_results as j_merge  # noqa: E402
from repro.core.dse import run_dse_full as j_run_full  # noqa: E402
from repro.core.dse import tile_variants as j_variants  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import dataflows as tdf  # noqa: E402
from repro_torch.core.dse import DSEConfig, merge_results, run_dse, \
    run_dse_full, tile_variants  # noqa: E402
from repro_torch.resilience.errors import SpecError  # noqa: E402

PE_RANGE = tuple(range(16, 513, 32))
BW_RANGE = (4.0, 8.0, 16.0, 32.0, 64.0)
SCALES = (1, 2)
OBJECTIVES = ("throughput", "energy", "edp")


@pytest.fixture(scope="module")
def both():
    jop = jta.conv2d("c2", k=64, c=64, y=114, x=114, r=3, s=3)
    top = interop.layer_from_plain(dataclasses.asdict(jop))
    ref = j_run_full(jop, "KC-P", JCfg(pe_range=PE_RANGE, bw_range=BW_RANGE),
                     scales=SCALES)
    port = run_dse_full(top, "KC-P",
                        DSEConfig(pe_range=PE_RANGE, bw_range=BW_RANGE),
                        scales=SCALES, device="cpu")
    return ref, port


def test_same_variants_and_grid(both):
    ref, port = both
    assert [r.tile_tag for r in port] == [r.tile_tag for r in ref]
    for r, p in zip(ref, port):
        np.testing.assert_array_equal(p.num_pes, r.num_pes)
        np.testing.assert_array_equal(p.noc_bw, r.noc_bw)
        assert p.n_evaluated == r.n_evaluated


def test_valid_masks_identical(both):
    ref, port = both
    for r, p in zip(ref, port):
        np.testing.assert_array_equal(p.valid, r.valid)
        assert p.n_valid == r.n_valid
    assert j_merge(ref)["n_valid"] == merge_results(port)["n_valid"] > 0


@pytest.mark.parametrize("objective", OBJECTIVES)
def test_best_design_identical(both, objective):
    ref, port = both
    for r, p in zip(ref, port):
        rb, pb = r.best(objective), p.best(objective)
        assert (pb["num_pes"], pb["noc_bw"]) == (rb["num_pes"], rb["noc_bw"])
        for k, v in rb.items():
            if isinstance(v, float):
                np.testing.assert_allclose(pb[k], v, rtol=1e-6, err_msg=k)
            else:
                assert pb[k] == v, k
    mr, mp = j_merge(ref)["best"][objective], merge_results(port)["best"][
        objective]
    assert (mp["num_pes"], mp["noc_bw"], mp["tile_tag"]) == \
        (mr["num_pes"], mr["noc_bw"], mr["tile_tag"])


def test_values_within_tolerance(both):
    ref, port = both
    for r, p in zip(ref, port):
        np.testing.assert_allclose(p.area_mm2, r.area_mm2, rtol=1e-6)
        np.testing.assert_allclose(p.power_mw, r.power_mw, rtol=1e-6)
        for f in dataclasses.fields(r.stats):
            np.testing.assert_allclose(
                np.asarray(getattr(p.stats, f.name)),
                np.asarray(getattr(r.stats, f.name)), rtol=1e-6,
                err_msg=f.name)
        np.testing.assert_array_equal(p.pareto(), r.pareto())


def test_system_invariant_holds(both):
    """tests/test_system.py's §5.2 invariant on the port's result."""
    _, port = both
    agg = merge_results(port)
    tb, eb = agg["best"]["throughput"], agg["best"]["energy"]
    assert tb["throughput"] >= eb["throughput"]
    assert eb["energy_pj"] <= tb["energy_pj"]
    assert tb["power_mw"] <= 450.0 and tb["area_mm2"] <= 16.0


@pytest.mark.parametrize("flow", ["C-P", "X-P", "YX-P", "YR-P", "KC-P"])
def test_tile_variants_match_reference(flow):
    from repro.core import dataflows as jdf
    jop = jta.conv2d("c2", k=64, c=64, y=114, x=114, r=3, s=3)
    jd = jdf.table3_for_layer(flow, jop)
    td = tdf.table3_for_layer(
        flow, interop.layer_from_plain(dataclasses.asdict(jop)))
    want = [(t, interop.plain_dataflow(d)) for t, d in
            j_variants(jd, (1, 2, 4, 8))]
    got = [(t, interop.plain_dataflow(d)) for t, d in
           tile_variants(td, (1, 2, 4, 8))]
    assert got == want


@pytest.mark.parametrize("field,value", [
    ("pe_range", ()), ("pe_range", (0, 8)), ("bw_range", (0.0,)),
    ("area_budget_mm2", 0.0), ("power_budget_mw", -1.0), ("batch", 0)])
def test_config_validation(field, value):
    with pytest.raises(SpecError) as e:
        DSEConfig(**{field: value})
    assert e.value.field == field


def test_chunked_batches_agree(both):
    """A small ``batch`` splits the grid into chunks; results are equal."""
    _, port = both
    top = interop.layer_from_plain(dataclasses.asdict(
        jta.conv2d("c2", k=64, c=64, y=114, x=114, r=3, s=3)))
    df = tdf.table3_for_layer("KC-P", top)
    r = run_dse(top, df, DSEConfig(pe_range=PE_RANGE, bw_range=BW_RANGE,
                                   batch=7), device="cpu")
    np.testing.assert_array_equal(r.stats.runtime, port[0].stats.runtime)
    np.testing.assert_array_equal(r.valid, port[0].valid)
