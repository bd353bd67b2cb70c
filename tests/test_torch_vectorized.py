"""Port of the batched evaluator (``repro_torch.core.vectorized``) against
the JAX package's jit+vmap'd ``batched_evaluator``, on the same int32 /
float32 design grids.

Tolerance: every feature within rtol 1e-6 of the reference; runtime and
macs, which are float32 images of exact integer arithmetic, equal.  The
port runs the reference's operations one by one in float32; the jitted
reference may fuse and reorder float32 sums, which moves the energy
columns by a few ulp."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import dataflows as jdf  # noqa: E402
from repro.core import dnn_models as jdm  # noqa: E402
from repro.core.vectorized import FEATURES as J_FEATURES  # noqa: E402
from repro.core.vectorized import batched_evaluator as j_eval  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core.model import analyze as t_analyze  # noqa: E402
from repro_torch.core.performance import HWConfig as THW  # noqa: E402
from repro_torch.core.vectorized import FEATURES  # noqa: E402
from repro_torch.core.vectorized import BatchStats, batched_evaluator, \
    evaluate_grid  # noqa: E402

# one single-level (C-P) and one two-level (KC-P) dataflow, on an early
# and a late VGG16 layer
CASES = [("vgg16-conv2", "C-P"), ("vgg16-conv2", "KC-P"),
         ("vgg16-conv11", "C-P"), ("vgg16-conv11", "KC-P")]


def _grid():
    rng = np.random.default_rng(11)
    pes = np.concatenate([np.arange(1, 65), rng.integers(65, 4097, 192)])
    bw = np.concatenate([rng.uniform(1, 4, 64),
                         rng.uniform(1, 128, 192)]).astype(np.float32)
    bw[::17] = np.round(bw[::17])  # integral bandwidths hit exact ceil-divs
    return pes.astype(np.int32), bw


def _pair(layer_name: str, flow: str):
    op = next(o for o in jdm.vgg16() if o.name == layer_name)
    df = jdf.table3_for_layer(flow, op)
    return (op, df, interop.layer_from_plain(dataclasses.asdict(op)),
            interop.dataflow_from_plain(*interop.plain_dataflow(df)))


@pytest.fixture(scope="module")
def features():
    """{case: (reference features, port features)} over one grid."""
    pes, bw = _grid()
    out = {}
    for case in CASES:
        jop, jd, top, td = _pair(*case)
        ref = np.asarray(j_eval(jop, jd)(jnp.asarray(pes), jnp.asarray(bw)))
        port = batched_evaluator(top, td, device="cpu")(
            torch.from_numpy(pes), torch.from_numpy(bw))
        out[case] = (ref, port)
    return out


def test_feature_layout_matches_reference():
    assert FEATURES == J_FEATURES


@pytest.mark.parametrize("case", CASES, ids="-".join)
def test_batched_features_match_reference(features, case):
    ref, port = features[case]
    assert port.dtype == torch.float32 and port.device.type == "cpu"
    assert tuple(port.shape) == ref.shape
    got = port.numpy()
    for i, name in enumerate(FEATURES):
        if name in ("runtime", "macs"):
            np.testing.assert_array_equal(got[:, i], ref[:, i], err_msg=name)
        else:
            np.testing.assert_allclose(got[:, i], ref[:, i], rtol=1e-6,
                                       err_msg=name)


@pytest.mark.parametrize("case", CASES, ids="-".join)
def test_batched_matches_port_faithful_engine(features, case):
    """Each batched row's runtime and macs equal the port's own scalar
    engine run at that design point.  (Utilization is left out: its PE-step
    counts exceed int32 on these layers and wrap in the batched engine, in
    the reference as in the port, while the scalar engine uses Python
    ints.)"""
    _, _, top, td = _pair(*case)
    pes, bw = _grid()
    got = features[case][1].numpy()
    for i in (0, 5, 63, 64, 200):
        s = t_analyze(top, td, THW(num_pes=int(pes[i]), noc_bw=float(bw[i])))
        assert got[i, 0] == np.float32(s.runtime)
        assert got[i, 2] == np.float32(s.total_macs)


def test_evaluate_grid_and_batch_stats():
    _, _, top, td = _pair("vgg16-conv11", "C-P")
    pes, bw = _grid()
    st = evaluate_grid(top, td, pes[:8], bw[:8], device="cpu")
    assert isinstance(st, BatchStats)
    full = batched_evaluator(top, td, device="cpu")(pes[:8], bw[:8])
    for i, name in enumerate(FEATURES):
        torch.testing.assert_close(getattr(st, name), full[:, i], rtol=0,
                                   atol=0)


def test_static_columns_broadcast():
    """Columns the hardware parameters never touch (here the peak NoC
    bandwidth of a layer that never waits on the PE count) still come
    back as float32[n]."""
    _, _, top, td = _pair("vgg16-conv11", "C-P")
    out = batched_evaluator(top, td, device="cpu")(
        torch.tensor([16], dtype=torch.int32), torch.tensor([4.0]))
    assert tuple(out.shape) == (1, len(FEATURES))
    assert torch.isfinite(out).all()
