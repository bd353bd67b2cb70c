"""Port of the faithful engine (``repro_torch.core``) against the JAX
package's: exact ``Stats`` over VGG16 × the five Table-3 dataflows, the
torch backend's dtype rules against JAX's weak typing, and the interop
round trips that feed both packages the same inputs."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import dataflows as jdf  # noqa: E402
from repro.core import dnn_models as jdm  # noqa: E402
from repro.core.model import analyze as j_analyze  # noqa: E402
from repro.core.performance import HWConfig as JHW  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import cluster_analysis as tca  # noqa: E402
from repro_torch.core.model import analyze as t_analyze  # noqa: E402
from repro_torch.core.performance import HWConfig as THW  # noqa: E402

FLOWS = ["C-P", "X-P", "YX-P", "YR-P", "KC-P"]
VGG16 = [op.name for op in jdm.vgg16()]
# (num_pes, noc_bw, multicast, spatial_reduction): the paper's default
# hardware, an under-provisioned array, and the Table-5 ablations
HWS = [(256, 32.0, True, True), (7, 3.5, True, True),
       (1024, 8.0, False, False)]


def _pair(layer_name: str, flow: str):
    op = next(o for o in jdm.vgg16() if o.name == layer_name)
    df = jdf.table3_for_layer(flow, op)
    return (op, df, interop.layer_from_plain(dataclasses.asdict(op)),
            interop.dataflow_from_plain(*interop.plain_dataflow(df)))


@pytest.mark.parametrize("flow", FLOWS)
@pytest.mark.parametrize("layer", VGG16)
def test_analyze_stats_equal(layer, flow):
    """Every Stats field of the port's faithful engine equals the
    reference's, counts, buffers, reuse classes and energy included."""
    jop, jdf_, top, tdf = _pair(layer, flow)
    for pes, bw, mc, red in HWS:
        a = j_analyze(jop, jdf_, JHW(num_pes=pes, noc_bw=bw, multicast=mc,
                                     spatial_reduction=red))
        b = t_analyze(top, tdf, THW(num_pes=pes, noc_bw=bw, multicast=mc,
                                    spatial_reduction=red))
        assert dataclasses.asdict(a) == dataclasses.asdict(b)


# ----------------------------------------------------------------------
# the backend seam: torch ops give JAX's result dtypes and values
# ----------------------------------------------------------------------

def _operand(kind):
    """(jax value, torch value) for one operand kind."""
    ints = np.array([-7, -1, 0, 3, 9], np.int32)
    floats = np.array([-2.5, -0.5, 0.0, 1.5, 9.25], np.float32)
    return {
        "i32": (jnp.asarray(ints), torch.from_numpy(ints)),
        "f32": (jnp.asarray(floats), torch.from_numpy(floats)),
        "py_int": (4, 4),
        "py_float": (2.5, 2.5),
        "np_int": (np.int64(4), np.int64(4)),
        "np_float": (np.float64(2.5), np.float64(2.5)),
    }[kind]


_J_OPS = {"maximum": jnp.maximum, "minimum": jnp.minimum,
          "floordiv": jnp.floor_divide}
_T_OPS = {"maximum": tca._t_maximum, "minimum": tca._t_minimum,
          "floordiv": tca._t_floordiv}
_KINDS = ["i32", "f32", "py_int", "py_float", "np_int", "np_float"]


@pytest.mark.parametrize("op", sorted(_J_OPS))
@pytest.mark.parametrize("a_kind", _KINDS)
@pytest.mark.parametrize("b_kind", ["i32", "f32", "py_int", "np_float"])
def test_torch_ops_follow_jax_weak_typing(op, a_kind, b_kind):
    (ja, ta), (jb, tb) = _operand(a_kind), _operand(b_kind)
    if op == "floordiv" and b_kind in ("i32", "f32"):
        jb, tb = jnp.abs(jb) + 1, torch.abs(tb) + 1  # no division by 0
    want = np.asarray(_J_OPS[op](ja, jb))
    got = _T_OPS[op](ta, tb)
    assert str(got.dtype).replace("torch.", "") == str(want.dtype)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("t_kind", ["i32", "f32", "py_int", "py_float"])
@pytest.mark.parametrize("f_kind", ["i32", "f32", "py_int", "py_float"])
def test_torch_where_follows_jax_weak_typing(t_kind, f_kind):
    cond = np.array([True, False, True, False, True])
    (jt, tt), (jf, tf) = _operand(t_kind), _operand(f_kind)
    want = np.asarray(jnp.where(jnp.asarray(cond), jt, jf))
    got = tca._t_where(torch.from_numpy(cond), tt, tf)
    assert str(got.dtype).replace("torch.", "") == str(want.dtype)
    np.testing.assert_array_equal(np.broadcast_to(got.numpy(), want.shape),
                                  want)


def test_hybrid_backend_keeps_static_values_python():
    xp = tca.hybrid_backend()
    assert xp.maximum(3, 5) == 5 and isinstance(xp.maximum(3, 5), int)
    assert xp.floordiv(-7, 2) == -4
    assert xp.where(True, 1, 0) == 1
    # numpy ints are not static: they take the tensor path, typed int32
    out = xp.maximum(np.int64(3), 5)
    assert isinstance(out, torch.Tensor) and out.dtype == torch.int32
    n = torch.tensor([1, 9], dtype=torch.int32)
    assert xp.eq(n, 9).dtype == torch.int32


def test_unit_counts_int32_like_reference():
    """Cluster unit counts on a tensor of PE counts stay int32, as the
    reference's do with x64 off."""
    from repro.core.cluster_analysis import hybrid_backend as jhb
    from repro.core.cluster_analysis import unit_counts as j_units
    pes = np.array([1, 7, 64, 300, 4096], np.int32)
    want = j_units(jhb(), jnp.asarray(pes), (64, 3))
    got = tca.unit_counts(tca.hybrid_backend(), torch.from_numpy(pes),
                          (64, 3))
    for w, g in zip(want, got):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ----------------------------------------------------------------------
# interop
# ----------------------------------------------------------------------

@pytest.mark.parametrize("model", sorted(jdm.MODELS))
def test_interop_layers_round_trip(model):
    for op in jdm.MODELS[model]():
        port = interop.layer_from_plain(dataclasses.asdict(op))
        assert dataclasses.asdict(port) == dataclasses.asdict(op)
        assert port.total_macs == op.total_macs


def test_interop_dataflows_round_trip():
    flows = [*jdf.TABLE3.values(), *jdf.FIG5.values(), jdf.FIG4,
             jdf.ROW_STATIONARY_6PE, jdf.yx_p(7, 2)]
    for df in flows:
        port = interop.dataflow_from_plain(*interop.plain_dataflow(df))
        assert interop.plain_dataflow(port) == interop.plain_dataflow(df)
        assert str(port) == str(df)


def test_interop_rejects_mismatched_layer():
    op = jdm.vgg16()[0]
    plain = dataclasses.asdict(op)
    plain["iter_entries"] = plain["iter_entries"][:-1]
    with pytest.raises(ValueError):
        interop.layer_from_plain(plain)
