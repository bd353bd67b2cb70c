"""Port of the batched evaluator (``repro_torch.core.vectorized``) against
the JAX package's jit+vmap'd ``batched_evaluator``, on the same int32 /
float32 design grids.

Tolerance: every feature within rtol 1e-6 of the reference; runtime and
macs, which are float32 images of exact integer arithmetic, equal.  The
port runs the reference's operations one by one in float32; the jitted
reference may fuse and reorder float32 sums, which moves the energy
columns by a few ulp."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

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


# ----------------------------------------------------------------------
# Parity repairs: the reference's executables, at bandwidths below 1
# ----------------------------------------------------------------------
#
# Under jit, XLA folds the two static terms of ``ceil_div``'s
# ``a + b - 1`` before the add (``(2 + bw) - 1`` runs as ``bw + 1``), and
# the port now computes the folded order.  The reference executables are
# made here with XLA's CPU code generation capped at AVX: on a host with
# FMA, XLA also contracts some ``a * b + c`` into one fused multiply-add
# (``model.py``'s ``runtime + occ * step`` among them), which rounds once
# where the program rounds twice; the port keeps the program's rounding
# (ROADMAP §3).  Capped, the executable computes the program as written.

GRID_LAYERS = ("vgg16-conv2", "vgg16-conv5", "vgg16-conv11", "vgg16-fc1")
GRID_FLOWS = ("C-P", "X-P", "YX-P", "YR-P", "KC-P")
FC1_ROW = (4049, 0.1)             # vgg16-fc1 × X-P: 13/12 of the runtime
RESIDUAL_ROW = (4049, 0.1)        # vgg16-conv11 × KC-P: FMA in the jit

_GRID_REF = r"""
import sys
import numpy as np
import jax.numpy as jnp
from repro.core import dataflows, dnn_models
from repro.core.vectorized import batched_evaluator
layers, flows = sys.argv[3].split(","), sys.argv[4].split(",")
d = np.load(sys.argv[1])
pes, bw = jnp.asarray(d["pes"]), jnp.asarray(d["bw"])
out = {}
for name in layers:
    op = next(o for o in dnn_models.vgg16() if o.name == name)
    for flow in flows:
        f = batched_evaluator(op, dataflows.table3_for_layer(flow, op))
        out[name + "|" + flow] = np.asarray(f(pes, bw))
np.savez(sys.argv[2], **out)
"""


def _low_bw_grid():
    rng = np.random.default_rng(20)
    pes = np.concatenate([rng.integers(1, 4097, 46), [4049, 2293, 64, 1]])
    bw = np.concatenate([np.arange(1, 10) / 10,
                         [1.0, 1.5, 7.3, 105.28]]).astype(np.float32)
    p, b = np.meshgrid(pes.astype(np.int32), bw, indexing="ij")
    return p.ravel(), b.ravel()


@pytest.fixture(scope="module")
def low_bw_reference(tmp_path_factory):
    """{(layer, flow): features} of the reference's jitted
    ``batched_evaluator`` on the low-bandwidth grid, made with XLA's CPU
    code generation capped at AVX: one process of its own per layer, run
    side by side (each compiles five executables)."""
    d = tmp_path_factory.mktemp("low_bw")
    pes, bw = _low_bw_grid()
    np.savez(d / "grid.npz", pes=pes, bw=bw)
    flags = os.environ.get("XLA_FLAGS", "")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"{flags} --xla_cpu_max_isa=AVX".strip(),
               PYTHONPATH=str(Path(__file__).resolve().parents[1] / "src"))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _GRID_REF, str(d / "grid.npz"),
         str(d / f"{layer}.npz"), layer, ",".join(GRID_FLOWS)],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
        for layer in GRID_LAYERS]
    for p in procs:
        _, err = p.communicate(timeout=600)
        assert p.returncode == 0, err.decode()[-2000:]
    out = {}
    for layer in GRID_LAYERS:
        ref = np.load(d / f"{layer}.npz")
        out.update({tuple(k.split("|")): ref[k] for k in ref.files})
    return out


def _port_features(layer: str, flow: str, pes, bw) -> np.ndarray:
    _, _, top, td = _pair(layer, flow)
    return batched_evaluator(top, td, device="cpu")(
        torch.from_numpy(np.asarray(pes, np.int32)),
        torch.from_numpy(np.asarray(bw, np.float32))).numpy()


def test_fc1_low_bandwidth_row_matches_jitted_reference():
    """The smallest input of the fold: 0.1f + 1 is 1.1 where
    (2 + 0.1f) - 1 is 1.0999999, so the NoC delay is 11 cycles, not 10."""
    jop, jd, _, _ = _pair("vgg16-fc1", "X-P")
    pes = np.array([FC1_ROW[0]], np.int32)
    bw = np.array([FC1_ROW[1]], np.float32)
    ref = np.asarray(j_eval(jop, jd)(jnp.asarray(pes), jnp.asarray(bw)))
    assert ref[0, 0] == np.float32(1.3358858e9)
    got = _port_features("vgg16-fc1", "X-P", pes, bw)
    assert got[0, 0] == ref[0, 0]
    assert got[0, 2] == ref[0, 2]


@pytest.mark.parametrize("layer", GRID_LAYERS)
def test_low_bandwidth_grid_matches_reference(low_bw_reference, layer):
    pes, bw = _low_bw_grid()
    for flow in GRID_FLOWS:
        ref = low_bw_reference[(layer, flow)]
        got = _port_features(layer, flow, pes, bw)
        for i, name in enumerate(FEATURES):
            msg = f"{layer} {flow} {name}"
            if name in ("runtime", "macs"):
                np.testing.assert_array_equal(got[:, i], ref[:, i],
                                              err_msg=msg)
            else:
                np.testing.assert_allclose(got[:, i], ref[:, i], rtol=1e-6,
                                           err_msg=msg)


def test_residual_row_matches_the_executable_without_fma(low_bw_reference):
    """vgg16-conv11 × KC-P at (4049, 0.1), the row left after the two
    repairs: the port equals the reference's executable without FMA bit
    for bit (the host's own executable rounds ``runtime + occ * step``
    once, with an FMA: 5147974700 against 5147974000, ROADMAP §3)."""
    pes, bw = _low_bw_grid()
    i = int(np.flatnonzero((pes == RESIDUAL_ROW[0])
                           & (bw == np.float32(RESIDUAL_ROW[1])))[0])
    got = _port_features("vgg16-conv11", "KC-P", pes[i:i + 1], bw[i:i + 1])
    np.testing.assert_array_equal(
        got[0], low_bw_reference[("vgg16-conv11", "KC-P")][i])
    assert got[0, 0] == np.float32(5147974000.0)


def test_float_floor_division_follows_jnp():
    """``floor_divide`` of floats rounds a half away from zero, as
    ``jnp.floor_divide``'s ``lax.round`` does; torch's rounds it down.
    Integers keep ``torch.floor_divide``."""
    import importlib
    from repro_torch.core.cluster_analysis import _t_floordiv, floor_divide
    me = importlib.import_module(
        "repro_torch.kernels.maestro_eval.maestro_eval")
    assert me._floor_divide is floor_divide
    a, b = torch.tensor([11507717.0]), torch.tensor([1.5])
    assert float(_t_floordiv(a, b)) == 7671811.0
    assert float(torch.floor_divide(a, b)) == 7671810.0
    assert float(_t_floordiv(11507717.0, b)) == 7671811.0
    rng = np.random.default_rng(4)
    b = rng.uniform(0.5, 4.0, 200_000).astype(np.float32)
    q = rng.uniform(2 ** 22, 2 ** 23, 200_000)
    a = (q * b).astype(np.float32)
    a[:1000] = -a[:1000]
    want = np.asarray(jnp.floor_divide(jnp.asarray(a), jnp.asarray(b)))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    got = _t_floordiv(ta, tb).numpy()
    np.testing.assert_array_equal(got, want)
    assert (torch.floor_divide(ta, tb).numpy() != want).any()
    ia = torch.tensor([-7, 7, 9], dtype=torch.int32)
    ib = torch.tensor([2, -2, 3], dtype=torch.int32)
    out = _t_floordiv(ia, ib)
    assert out.dtype == torch.int32 and out.tolist() == [-4, -4, 3]
