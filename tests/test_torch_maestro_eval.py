"""Port of the maestro_eval kernel module against the JAX package's:
field-equal ``EvalTables``, the plain PyTorch ``closed_form_features``
against the Pallas kernel (interpret mode) and its jnp oracle at rtol 1e-6,
and against the faithful engine at ``tests/test_kernels.py``'s tolerances.
The CUDA kernel itself runs only on the card (``tests/test_torch_cuda.py``)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import dataflows as jdf  # noqa: E402
from repro.core import dnn_models as jdm  # noqa: E402
from repro.core import tensor_analysis as jta  # noqa: E402
from repro.kernels.maestro_eval import build_tables as j_build  # noqa: E402
from repro.kernels.maestro_eval import maestro_eval as j_kernel  # noqa: E402
from repro.kernels.maestro_eval import maestro_eval_ref as j_ref  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core.model import analyze as t_analyze  # noqa: E402
from repro_torch.core.performance import HWConfig as THW  # noqa: E402
from repro_torch.kernels.maestro_eval import (  # noqa: E402
    FEATURES, build_tables, closed_form_features, dse_eval, maestro_eval,
    maestro_eval_ref)
from repro_torch.kernels.maestro_eval.tables import EvalTables  # noqa: E402


def _kernel_ops():
    """``tests/test_kernels.py::_cases``' layers."""
    return [
        jta.conv2d("late", k=128, c=96, y=14, x=14, r=3, s=3),
        jta.fc("fc", k=512, c=1024),
        jta.conv2d("early", k=64, c=3, y=112, x=112, r=7, s=7, stride=2),
    ]


CASES = [(op.name, flow) for op in _kernel_ops() for flow in ("C-P", "X-P")]
VGG_CASES = [(op.name, flow) for op in jdm.vgg16() for flow in ("C-P", "X-P")]


def _pair(layer_name: str, flow: str):
    op = next(o for o in [*_kernel_ops(), *jdm.vgg16()]
              if o.name == layer_name)
    df = jdf.table3_for_layer(flow, op)
    return (op, df, interop.layer_from_plain(dataclasses.asdict(op)),
            interop.dataflow_from_plain(*interop.plain_dataflow(df)))


def _designs(seed: int):
    """pes 1..64 (where ``rem - s`` goes negative) plus random draws."""
    rng = np.random.default_rng(seed)
    pes = np.concatenate([np.arange(1, 65), rng.integers(65, 16385, 64)])
    bw = np.concatenate([rng.uniform(1, 4, 32), rng.uniform(1, 128, 96)])
    bw[::9] = np.round(bw[::9])
    return pes.astype(np.int32), bw.astype(np.float32)


def test_all_vgg16_single_level_pairs_build():
    assert len(VGG_CASES) == 32


@pytest.mark.parametrize("case", CASES + VGG_CASES, ids="-".join)
def test_tables_equal_reference(case):
    jop, jd, top, td = _pair(*case)
    want = dataclasses.asdict(j_build(jop, jd))
    got = dataclasses.asdict(build_tables(top, td))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == want[k], k
    assert interop.tables_from_plain(want) == build_tables(top, td)


@pytest.mark.parametrize("case", CASES + VGG_CASES[::5], ids="-".join)
def test_plain_matches_pallas_interpret_and_ref(case):
    jop, jd, top, td = _pair(*case)
    jt, tt = j_build(jop, jd), build_tables(top, td)
    pes, bw = _designs(0)
    krn = np.asarray(j_kernel(jnp.asarray(pes), jnp.asarray(bw), tables=jt,
                              interpret=True))
    ref = np.asarray(j_ref(pes, bw, tables=jt))
    got = closed_form_features(torch.from_numpy(pes), torch.from_numpy(bw),
                               tt)
    assert got.dtype == torch.float32 and tuple(got.shape) == krn.shape
    np.testing.assert_allclose(got.numpy(), krn, rtol=1e-6)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6)


@pytest.mark.parametrize("case", CASES, ids="-".join)
def test_plain_matches_engine(case):
    """``tests/test_kernels.py::test_maestro_eval_matches_engine`` for the
    port: the closed form against the port's faithful engine."""
    _, _, top, td = _pair(*case)
    tt = build_tables(top, td)
    rng = np.random.default_rng(1)
    pes = rng.integers(2, 512, 8).astype(np.int32)
    bw = rng.uniform(2, 64, 8).astype(np.float32)
    feats = maestro_eval_ref(pes, bw, tables=tt).numpy()
    for i in range(len(pes)):
        s = t_analyze(top, td, THW(num_pes=int(pes[i]), noc_bw=float(bw[i]),
                                   noc_latency=2.0))
        assert np.isclose(feats[i, 0], s.runtime, rtol=1e-4)
        assert np.isclose(feats[i, 1], s.total_macs, rtol=1e-4)
        assert np.isclose(feats[i, 3], s.utilization, atol=1e-5)


def test_ext_of_floors_like_reference():
    jop, jd, top, td = _pair("early", "X-P")
    jt, tt = j_build(jop, jd), build_tables(top, td)
    assert tt.sp_kind == "conv"
    size = np.arange(-3, 40, dtype=np.int32)
    want = np.asarray(jt.ext_of(jnp.asarray(size)))
    got = tt.ext_of(torch.from_numpy(size))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_dse_eval_cpu_takes_plain_path():
    _, _, top, td = _pair("late", "C-P")
    pes, bw = _designs(2)
    before = maestro_eval.launches
    out = dse_eval(torch.from_numpy(pes), torch.from_numpy(bw), op=top,
                   dataflow=td)
    assert maestro_eval.launches == before
    assert out.device.type == "cpu" and out.shape == (len(pes),
                                                      len(FEATURES))
    torch.testing.assert_close(
        out, closed_form_features(torch.from_numpy(pes),
                                  torch.from_numpy(bw),
                                  build_tables(top, td)), rtol=0, atol=0)
    # numpy input goes where the caller says
    out2 = dse_eval(pes, bw, tables=build_tables(top, td), device="cpu")
    torch.testing.assert_close(out2, out, rtol=0, atol=0)
    assert maestro_eval.launches == before


def test_dse_eval_refuses_tensors_off_the_named_device():
    """Tensors on the CPU with ``device="cuda"`` raise instead of quietly
    running the plain version; naming their own device is fine."""
    _, _, top, td = _pair("late", "C-P")
    tt = build_tables(top, td)
    pes, bw = _designs(3)
    p, b = torch.from_numpy(pes), torch.from_numpy(bw)
    before = maestro_eval.launches
    for dev in ("cuda", "cuda:0", torch.device("cuda")):
        with pytest.raises(ValueError, match="device"):
            dse_eval(p, b, tables=tt, device=dev)
    torch.testing.assert_close(dse_eval(p, b, tables=tt, device="cpu"),
                               closed_form_features(p, b, tt), rtol=0,
                               atol=0)
    assert maestro_eval.launches == before


def test_kernel_wrapper_takes_plain_version_on_cpu():
    """On CPU tensors the wrapper runs the plain version and counts no
    launch; inputs it cannot take raise."""
    _, _, top, td = _pair("late", "C-P")
    tt = build_tables(top, td)
    pes, bw = _designs(6)
    p, b = torch.from_numpy(pes), torch.from_numpy(bw)
    before = maestro_eval.launches
    torch.testing.assert_close(maestro_eval(p, b, tables=tt),
                               closed_form_features(p, b, tt), rtol=0,
                               atol=0)
    with pytest.raises(TypeError):
        maestro_eval(p.long(), b, tables=tt)
    with pytest.raises(ValueError):
        maestro_eval(p, b[:4], tables=tt)
    with pytest.raises(TypeError):
        maestro_eval(pes, bw, tables=tt)
    assert maestro_eval.launches == before


def test_tables_reject_multi_level_dataflows():
    _, _, top, _ = _pair("late", "C-P")
    from repro_torch.core import dataflows as tdf
    for flow in ("YX-P", "YR-P", "KC-P"):
        with pytest.raises(ValueError):
            build_tables(top, tdf.table3_for_layer(flow, top))


def test_eval_tables_hashable():
    """The kernel caches its device case table per EvalTables."""
    _, _, top, td = _pair("late", "C-P")
    assert isinstance(hash(build_tables(top, td)), int)
    assert isinstance(build_tables(top, td), EvalTables)


def _edge_designs():
    """``tests/test_torch_cuda.py::_edge_designs``: pes where ``rem - s``
    goes negative, random ones, and ones where n * o and (n - 1) * o wrap
    int32, each at bw 1, non-integer bw, and bw so small that the float
    floor division's quotient crosses 2^24, the edge of the CUDA kernel's
    exact remainder."""
    rng = np.random.default_rng(11)
    pes = np.concatenate([np.arange(1, 65), rng.integers(65, 16385, 32),
                          2 ** 30 + np.arange(8), [2 ** 24, 2 ** 31 - 1]])
    bws = np.array([1.0, 3.5, 105.28, 0.75, 1024.0, 1e-6, 3e-6, 1e-5,
                    3e-5, 5e-5, 7e-5, 1e-4], dtype=np.float32)
    return (np.repeat(pes, len(bws)).astype(np.int32),
            np.tile(bws, len(pes)))


def _against_reference(case, pes, bw):
    """The plain version on (pes, bw) against the JAX package's oracle, bit
    for bit (NaN as NaN): the float floor division rounds halves away from
    zero in both (at the edge inputs ``torch.floor_divide``'s rounding of
    halves moved runtime by ~2e-7 relative, inside the rtol of 1e-6 of the
    tests above); and against its Pallas kernel in interpret mode, jitted
    whole, at rtol 1e-6."""
    jop, jd, top, td = _pair(*case)
    jt, tt = j_build(jop, jd), build_tables(top, td)
    got = closed_form_features(torch.from_numpy(pes), torch.from_numpy(bw),
                               tt).numpy()
    want = np.asarray(j_ref(pes, bw, tables=jt))
    assert want.shape == got.shape == (len(pes), len(FEATURES))
    same = (got.view(np.int32) == want.view(np.int32)) | (
        np.isnan(got) & np.isnan(want))
    assert same.all(), np.argwhere(~same)[:5]
    krn = np.asarray(j_kernel(jnp.asarray(pes), jnp.asarray(bw), tables=jt,
                              interpret=True))
    np.testing.assert_allclose(got, krn, rtol=1e-6)


@pytest.mark.parametrize("case", CASES, ids="-".join)
def test_plain_matches_reference_at_edge_inputs(case):
    _against_reference(case, *_edge_designs())


@pytest.mark.parametrize("n", [1, 3, 4, 255, 257, 4097, 2 ** 20 + 3])
def test_plain_matches_reference_at_ragged_sizes(n):
    """The CUDA tests' sizes; the Pallas kernel pads to its 1024-design
    block."""
    pes, bw = _designs(4)
    reps = -(-n // len(pes))
    pes, bw = np.tile(pes, reps)[:n], np.tile(bw, reps)[:n]
    for case in (CASES[1], CASES[5]):
        _against_reference(case, pes, bw)


def test_plain_takes_misaligned_slices():
    """Contiguous slices 4 bytes past an aligned start, as the CUDA kernel
    takes them, against the reference on the same values."""
    pes, bw = _designs(5)
    tt = build_tables(*_pair("early", "X-P")[2:])
    p, b = torch.from_numpy(pes), torch.from_numpy(bw)
    got = closed_form_features(p[1:], b[1:], tt)
    torch.testing.assert_close(got, closed_form_features(
        p[1:].clone(), b[1:].clone(), tt), rtol=0, atol=0)
    _against_reference(("early", "X-P"), pes[1:].copy(), bw[1:].copy())


def test_floor_div_constants_exact():
    """The host's multiply-shift constants give x // d for every x the
    kernel feeds them (0 <= x < 2^31; a negative dividend folds to ~x), at
    the ends of the range and around multiples of d."""
    from repro_torch.kernels.maestro_eval.maestro_eval import _floor_div
    rng = np.random.default_rng(0)
    divisors = list(range(1, 130)) + [2 ** k + j for k in range(8, 31)
                                      for j in (-1, 0, 1) if 2 ** k + j
                                      < 2 ** 31]
    for d in divisors:
        m = _floor_div(d)
        assert m.d == d and 0 < m.magic < 2 ** 32
        mult = rng.integers(0, (2 ** 31 - 1) // d + 1, 64) * d
        xs = np.concatenate([np.arange(0, 300), 2 ** 31 - 1 - np.arange(300),
                             mult, mult - 1, mult + d - 1,
                             rng.integers(0, 2 ** 31, 256)])
        xs = xs[(xs >= 0) & (xs < 2 ** 31)].astype(np.uint64)
        q = (xs * np.uint64(m.magic)) >> np.uint64(m.shift)
        np.testing.assert_array_equal(q, xs // np.uint64(d), err_msg=str(d))
        a = -xs.astype(np.int64) - 1  # folds to x = ~a
        np.testing.assert_array_equal(~q.astype(np.int64), a // d)
    for bad in (0, -1, 2 ** 31):
        with pytest.raises(ValueError):
            _floor_div(bad)


def _exact_fmod(a, b):
    """``exact_fmod`` of ``csrc/maestro_eval.cu`` in numpy: one float32
    division, a - trunc(q) * b rounded once (in float64, where the product
    of two float32 is exact and so is the difference the source's fmaf
    rounds), one correction; np.fmod outside the domain."""
    with np.errstate(all="ignore"):
        q = a / b
        dom = (np.abs(q) < np.float32(2 ** 24)) & np.isfinite(b)
        r = (a.astype(np.float64) - np.trunc(q).astype(np.float64)
             * b.astype(np.float64)).astype(np.float32)
        r = np.where(np.where(a >= 0, r < 0, r > 0),
                     r + np.copysign(b, a), r).astype(np.float32)
        return np.where(dom, np.copysign(r, a), np.fmod(a, b)), dom


def test_exact_fmod_scheme_bit_equal_to_fmod():
    """The kernel's remainder scheme bit for bit against fmod (the sign of
    a zero included) on float32 pairs of spread exponents, on quotients
    within 3e-8 of an integer (where RN(a / b) rounds up to the next one),
    and across the 2^24 edge of its domain."""
    rng = np.random.default_rng(0)
    n = 200_000
    b = (rng.uniform(-1, 1, n) * 2.0 ** rng.integers(-30, 40, n)).astype(
        np.float32)
    spread = (rng.uniform(-1, 1, n) * 2.0 ** rng.integers(-30, 40, n))
    k = rng.integers(0, 2 ** 25, n).astype(np.float64)
    near = b.astype(np.float64) * k * (1 + rng.uniform(-3e-8, 3e-8, n))
    inside = 0
    for a in (spread, near, np.round(near), -near):
        a = a.astype(np.float32)
        got, dom = _exact_fmod(a, b)
        with np.errstate(all="ignore"):
            want = np.fmod(a, b)
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))
        inside += int(dom.sum())
    assert 0.5 * 4 * n < inside < 4 * n
