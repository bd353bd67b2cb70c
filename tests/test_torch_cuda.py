"""The port on the card: the maestro_eval, flash_attention (forward and
backward) and linear_scan (forward and backward) CUDA kernels against
their plain PyTorch versions, their launch counts and input checks,
training through the kernels, the graph audit of the DSE evaluators, and
the default device.  Imports no JAX, so it runs where only
PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

Without a CUDA device every test here skips (the kernels have no CPU mode).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import dnn_models, tensor_analysis  # noqa: E402
from repro_torch.core.dataflows import table3_for_layer  # noqa: E402
from repro_torch.core.dse import DSEConfig, run_dse  # noqa: E402
from repro_torch.devices import resolve_device  # noqa: E402
from repro_torch.configs import REGISTRY  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    attention_ref, flash_attention, flash_attention_with_lse)
from repro_torch.kernels.flash_attention.flash_attention import (  # noqa: E402
    tiles, wgmma_occupancy)
from repro_torch.kernels.linear_scan import (  # noqa: E402
    linear_scan, linear_scan_bwd, linear_scan_bwd_ref, linear_scan_ref,
    linear_scan_with_states)
from repro_torch.kernels.maestro_eval import (  # noqa: E402
    build_tables, closed_form_features, dse_eval, maestro_eval)
from repro_torch.models import registry  # noqa: E402
from repro_torch.models.param import init_params  # noqa: E402

pytestmark = pytest.mark.gpu

OPS = {
    "late": tensor_analysis.conv2d("late", k=128, c=96, y=14, x=14, r=3,
                                   s=3),
    "fc": tensor_analysis.fc("fc", k=512, c=1024),
    "early": tensor_analysis.conv2d("early", k=64, c=3, y=112, x=112, r=7,
                                    s=7, stride=2),
}
CASES = [(name, flow) for name in OPS for flow in ("C-P", "X-P")]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _tables(name, flow):
    op = OPS[name]
    return build_tables(op, table3_for_layer(flow, op))


def _designs(seed, device):
    rng = np.random.default_rng(seed)
    pes = np.concatenate([np.arange(1, 65), rng.integers(65, 16385, 4000)])
    bw = rng.uniform(1, 1024, len(pes))
    bw[::9] = np.round(bw[::9])
    return (torch.from_numpy(pes.astype(np.int32)).to(device),
            torch.from_numpy(bw.astype(np.float32)).to(device))


@pytest.mark.parametrize("case", CASES, ids="-".join)
def test_kernel_matches_plain(cuda, case):
    T = _tables(*case)
    p, b = _designs(3, cuda)
    got = maestro_eval(p, b, tables=T)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, closed_form_features(p, b, T),
                               rtol=1e-6, atol=0)


def test_kernel_on_every_vgg16_table(cuda):
    p, b = _designs(5, cuda)
    for op in dnn_models.vgg16():
        for flow in ("C-P", "X-P"):
            T = build_tables(op, table3_for_layer(flow, op))
            torch.testing.assert_close(maestro_eval(p, b, tables=T),
                                       closed_form_features(p, b, T),
                                       rtol=1e-6, atol=0)


def test_dse_eval_counts_launches(cuda):
    T = _tables("late", "X-P")
    before = maestro_eval.launches
    p, b = _designs(4, cuda)
    out = dse_eval(p, b, tables=T)
    assert out.is_cuda and maestro_eval.launches == before + 1
    dse_eval(p.cpu(), b.cpu(), tables=T)  # the plain path launches nothing
    assert maestro_eval.launches == before + 1
    with pytest.raises(ValueError, match="device"):
        dse_eval(p, b, tables=T, device="cpu")
    assert maestro_eval.launches == before + 1


def test_kernel_rejects_bad_inputs(cuda):
    T = _tables("late", "C-P")
    p = torch.ones(8, dtype=torch.int32, device=cuda)
    b = torch.ones(8, device=cuda)
    with pytest.raises(TypeError):
        maestro_eval(p.long(), b, tables=T)
    with pytest.raises(ValueError):
        maestro_eval(p[::2], b[::2], tables=T)
    with pytest.raises(ValueError):
        maestro_eval(p, b[:4], tables=T)
    with pytest.raises(ValueError):
        maestro_eval(p, b.cpu(), tables=T)
    assert maestro_eval(p[:0], b[:0], tables=T).shape == (0, 5)


def _edge_designs():
    """pes where ``rem - s`` goes negative, random ones, and ones where
    n * o and (n - 1) * o wrap int32, each at bw 1, non-integer bw, and
    bw so small that ``floordiv_f``'s quotient crosses 2^24, the edge of
    the kernel's exact remainder, into its fmodf slow path."""
    rng = np.random.default_rng(11)
    pes = np.concatenate([np.arange(1, 65), rng.integers(65, 16385, 32),
                          2 ** 30 + np.arange(8), [2 ** 24, 2 ** 31 - 1]])
    bws = np.array([1.0, 3.5, 105.28, 0.75, 1024.0, 1e-6, 3e-6, 1e-5,
                    3e-5, 5e-5, 7e-5, 1e-4], dtype=np.float32)
    return (np.repeat(pes, len(bws)).astype(np.int32),
            np.tile(bws, len(pes)))


def _beyond_exact_domain(p, b, T) -> torch.Tensor:
    """Designs whose ingress ``floordiv_f`` quotient (delta + bw - 1) / bw
    is 2^24 or more: the kernel's fmodf slow path."""
    span = T.sp_s + (p - 1) * T.sp_o  # int32, wraps as the kernel's
    delta = T.delta_a + T.delta_b * torch.clamp(span, max=T.sp_D).float()
    return (((delta + b) - 1.0) / b).abs() >= 2.0 ** 24


@pytest.mark.parametrize("n", [1, 3, 4, 255, 257, 4097, 2 ** 20 + 3])
def test_kernel_bit_equal_at_ragged_sizes(cuda, n):
    p, b = _designs(7, cuda)
    reps = -(-n // len(p))
    p, b = p.repeat(reps)[:n].contiguous(), b.repeat(reps)[:n].contiguous()
    for case in CASES:
        T = _tables(*case)
        got = maestro_eval(p, b, tables=T)
        torch.cuda.synchronize()
        assert got.shape == (n, 5)
        assert torch.equal(got, closed_form_features(p, b, T)), case


def test_kernel_bit_equal_on_misaligned_slices(cuda):
    """Contiguous slices 4 and 8 bytes past a 16-byte boundary: the kernel
    takes them as they are."""
    p, b = _designs(8, cuda)
    n = len(p) - 3
    for ps, bs in ((p[1:n + 1], b[1:n + 1]), (p[1:n + 1], b[2:n + 2]),
                   (p[3:n + 3], b[:n])):
        assert ps.is_contiguous() and bs.is_contiguous()
        for case in CASES:
            T = _tables(*case)
            assert torch.equal(maestro_eval(ps, bs, tables=T),
                               closed_form_features(ps, bs, T)), case


def test_kernel_bit_equal_at_edge_inputs(cuda):
    pes, bw = _edge_designs()
    p, b = torch.from_numpy(pes).to(cuda), torch.from_numpy(bw).to(cuda)
    slow = 0
    for case in CASES:
        T = _tables(*case)
        got = maestro_eval(p, b, tables=T)
        want = closed_form_features(p, b, T)
        same = (got == want) | (torch.isnan(got) & torch.isnan(want))
        assert bool(same.all()), case
        slow += int(_beyond_exact_domain(p, b, T).sum())
    assert 0 < slow < len(CASES) * len(p)


def test_kernel_bit_equal_past_2_24_designs(cuda):
    n = 2 ** 24 + 3
    g = torch.Generator(device=cuda).manual_seed(0)
    p = torch.randint(1, 16385, (n,), generator=g, device=cuda,
                      dtype=torch.int32)
    b = torch.rand(n, generator=g, device=cuda) * 1023 + 1
    T = _tables("early", "X-P")
    assert torch.equal(maestro_eval(p, b, tables=T),
                       closed_form_features(p, b, T))


def test_default_device_is_cuda(cuda):
    assert resolve_device().type == "cuda"
    op = dnn_models.vgg16()[10]
    cfg = DSEConfig(pe_range=(8, 16), bw_range=(1.0, 2.0))
    r = run_dse(op, table3_for_layer("C-P", op), cfg)
    ref = run_dse(op, table3_for_layer("C-P", op), cfg, device="cpu")
    np.testing.assert_array_equal(r.stats.runtime, ref.stats.runtime)
    np.testing.assert_allclose(r.stats.energy_pj, ref.stats.energy_pj,
                               rtol=1e-6)


# ----------------------------------------------------------------------
# flash_attention
# ----------------------------------------------------------------------

FLASH_SHAPES = [  # tests/test_kernels.py:19-28
    (1, 128, 128, 2, 2, 64, True),
    (2, 256, 256, 4, 1, 64, True),     # MQA
    (1, 256, 256, 8, 2, 128, True),    # GQA group 4
    (2, 128, 128, 2, 2, 64, False),    # bidirectional (encoder)
    (1, 512, 512, 2, 2, 64, True),     # multiple k blocks
    (1, 256, 256, 4, 2, 96, True),     # phi-3-vision-4.2b's head dim
    (1, 256, 256, 4, 2, 112, True),    # zamba2-7b's shared block's
]
# float32 sums in another order (2e-6); bf16 outputs round to 8 mantissa
# bits (2e-2): tests/test_kernels.py's tolerances
FLASH_TOL = {torch.float32: 2e-6, torch.bfloat16: 2e-2}


def _qkv(B, Sq, Sk, Hq, Hkv, D, dtype, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    return tuple(torch.randn(shape, generator=g, device=device).to(dtype)
                 for shape in ((B, Sq, Hq, D), (B, Sk, Hkv, D),
                               (B, Sk, Hkv, D)))


@pytest.fixture
def no_tf32():
    """The plain version's float32 products in full float32."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = old


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", FLASH_SHAPES, ids=str)
def test_flash_kernel_matches_plain(cuda, no_tf32, shape, dtype):
    """Every tile of the kernel (dtype, D) takes: bf16 at D = 64, 128 is
    the wgmma kernel at BK = 64 and 128, float32 the SIMT kernel."""
    *dims, causal = shape
    q, k, v = _qkv(*dims, dtype, cuda)
    want = attention_ref(q, k, v, causal=causal).float()
    tol = FLASH_TOL[dtype]
    for blk_q, blk_k in tiles(dtype, dims[-1]):
        got = flash_attention(q, k, v, causal=causal, blk_q=blk_q,
                              blk_k=blk_k)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want, rtol=tol, atol=tol)


def test_flash_kernel_matches_plain_at_llama3_shape(cuda, no_tf32):
    """llama3-8b's attention: S = 2048, 32 query heads over 8 KV heads,
    D = 128, bf16, causal (B = 1)."""
    q, k, v = _qkv(1, 2048, 2048, 32, 8, 128, torch.bfloat16, cuda)
    got = flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    tol = FLASH_TOL[torch.bfloat16]
    torch.testing.assert_close(got.float(),
                               attention_ref(q, k, v, causal=True).float(),
                               rtol=tol, atol=tol)


def test_flash_kernel_independent_of_tile(cuda):
    q, k, v = _qkv(1, 256, 256, 2, 2, 64, torch.float32, cuda, seed=1)
    a = flash_attention(q, k, v, blk_q=64, blk_k=64)
    b = flash_attention(q, k, v, blk_q=128, blk_k=64)
    torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


@pytest.mark.parametrize("shape", [s for s in FLASH_SHAPES
                                   if s[5] in (64, 112, 128)], ids=str)
def test_flash_wgmma_kernel_independent_of_tile(cuda, shape):
    """BK = 64 and 128 round P to bf16 against other running maxima; the
    outputs agree within one bf16 ulp at the scale of each output row (the
    D values of one query and head)."""
    *dims, causal = shape
    q, k, v = _qkv(*dims, torch.bfloat16, cuda, seed=1)
    a, b = (flash_attention(q, k, v, causal=causal, blk_q=128,
                            blk_k=bk).float() for bk in (64, 128))
    top = torch.maximum(a.abs(), b.abs()).amax(-1, keepdim=True)
    ulp = torch.exp2(torch.floor(torch.log2(top.clamp(min=1e-30))) - 7)
    assert bool(((a - b).abs() <= ulp).all())


def test_flash_counts_launches_and_rejects_bad_inputs(cuda):
    q, k, v = _qkv(1, 128, 128, 4, 2, 64, torch.bfloat16, cuda)
    before = flash_attention.launches
    flash_attention(q, k, v)
    assert flash_attention.launches == before + 1
    flash_attention(q.cpu(), k.cpu(), v.cpu())  # the plain path
    assert flash_attention.launches == before + 1
    with pytest.raises(TypeError):
        flash_attention(q.float(), k, v)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v)
    with pytest.raises(ValueError, match="head dim"):
        q80, k80, v80 = _qkv(1, 128, 128, 4, 2, 80, torch.bfloat16, cuda)
        flash_attention(q80, k80, v80)
    with pytest.raises(ValueError, match="device"):
        flash_attention(q, k.cpu(), v)
    with pytest.raises(ValueError, match="aligned"):  # TMA's 16 bytes
        shifted = torch.empty(q.numel() + 1, dtype=q.dtype, device=cuda)
        flash_attention(shifted[1:].view(q.shape), k, v)
    with pytest.raises(ValueError, match="tile"):  # a SIMT tile, in bf16
        flash_attention(q, k, v, blk_q=64, blk_k=64)
    # under grad the forward launches once and builds a graph
    out = flash_attention(q.clone().requires_grad_(True), k, v)
    assert out.requires_grad
    assert flash_attention.launches == before + 2


# (B, S, Hq, Hkv, D): ragged head counts (3 over 1, 6 over 2, 5 over 5, 9
# over 3), every head dim, S = 64 and 192 on the SIMT forward (D = 32: the
# wgmma forward's tiles are 128), several 64-row q tiles per 128-key tile
# of the wgmma backward (S = 384, 256), and the two models' shapes at B = 1.
# In bf16, D = 96 runs the SIMT backward and D = 112 the wgmma one, both on
# the wgmma forward's lse, whose 128-row q tiles take S = 384 (three of
# them) and refuse 192; float32 keeps S = 192 as well.
BWD_SHAPES = [(1, 128, 3, 1, 16), (2, 64, 6, 2, 32), (1, 192, 5, 5, 32),
              (2, 128, 6, 2, 64), (1, 256, 4, 2, 128), (1, 384, 6, 2, 64),
              (2, 256, 9, 3, 128), (1, 2048, 16, 16, 128),
              (1, 2048, 32, 8, 128), (1, 384, 4, 2, 96),
              (1, 384, 6, 2, 112), (2, 256, 4, 4, 112)]
BWD_CASES = [(s, dt) for s in BWD_SHAPES
             for dt in (torch.float32, torch.bfloat16)] + [
    ((1, 192, 4, 2, 96), torch.float32), ((1, 192, 6, 2, 112), torch.float32)]
# relative L2 error of dq, dk, dv against attention_bwd_ref on the same
# inputs: float32 sums in another order (dq's atomics in a varying one);
# bf16 rounds the three outputs to 8 mantissa bits
BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def _rel_l2(got, want) -> float:
    return float((got.float() - want.float()).norm() /
                 want.float().norm().clamp(min=1e-30))


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "bidir"])
@pytest.mark.parametrize("shape,dtype", BWD_CASES,
                         ids=[f"{s}-{str(d)[6:]}" for s, d in BWD_CASES])
def test_flash_backward_kernel_matches_plain(cuda, no_tf32, shape, dtype,
                                             causal):
    from repro_torch.kernels.flash_attention import (attention_bwd_ref,
                                                     flash_attention_bwd)
    B, S, Hq, Hkv, D = shape
    q, k, v = _qkv(B, S, S, Hq, Hkv, D, dtype, cuda, seed=2)
    o, lse = flash_attention_with_lse(q, k, v, causal=causal)
    do = _qkv(B, S, S, Hq, Hkv, D, dtype, cuda, seed=3)[0]
    before = flash_attention.bwd_launches
    got = flash_attention_bwd(q, k, v, o, do, lse=lse, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.bwd_launches == before + 1
    want = attention_bwd_ref(q, k, v, o, do, causal=causal)
    for g, w, t in zip(got, want, (q, k, v)):
        assert g.dtype == dtype and g.shape == t.shape
        assert bool(torch.isfinite(g).all())
        assert _rel_l2(g, w) <= BWD_TOL[dtype]


def test_flash_attention_trains_through_the_kernels(cuda, no_tf32):
    """Autograd through ``flash_attention`` on the card (both kernels)
    against autograd of ``attention_ref`` in float32; bf16 inputs
    against the float32 gradient of the same bf16 values: the wgmma
    forward's o (P rounded to bf16) moves the gradient inside bf16's
    tolerance."""
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (t.requires_grad_(True) for t in _qkv(
            2, 256, 256, 8, 2, 64, dtype, cuda, seed=4))
        do = torch.randn(q.shape, device=cuda).to(dtype)
        fwd, bwd = flash_attention.launches, flash_attention.bwd_launches
        got = torch.autograd.grad(flash_attention(q, k, v), (q, k, v), do)
        assert flash_attention.launches == fwd + 1
        assert flash_attention.bwd_launches == bwd + 1
        qf, kf, vf = (t.detach().float().requires_grad_(True)
                      for t in (q, k, v))
        want = torch.autograd.grad(attention_ref(qf, kf, vf), (qf, kf, vf),
                                   do.float())
        for g, w in zip(got, want):
            assert _rel_l2(g, w) <= BWD_TOL[dtype]


def test_flash_backward_refuses_double_backward_and_bad_inputs(cuda):
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    q, k, v = _qkv(1, 128, 128, 2, 1, 32, torch.float32, cuda)
    qg = q.clone().requires_grad_(True)
    o = flash_attention(qg, k, v)
    dq, = torch.autograd.grad((o * o).sum(), qg, create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable"):
        dq.sum().backward()
    with pytest.raises(ValueError, match="multiples of 64"):
        flash_attention_bwd(q[:, :96], k, v, q[:, :96], q[:, :96])
    with pytest.raises(ValueError, match="one device"):
        flash_attention_bwd(q, k, v, q, q.cpu())


# the forward kernels' lse against attention_ref's: float32 sums in another
# order; the wgmma kernel keeps m and l in base 2 (exp2, log2, times ln 2)
LSE_TOL = 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", FLASH_SHAPES, ids=str)
def test_flash_forward_writes_lse(cuda, no_tf32, shape, dtype):
    """Both forward kernels (every tile) write the plain lse, and their o
    is the same, bit for bit, whether or not lse is asked for."""
    *dims, causal = shape
    q, k, v = _qkv(*dims, dtype, cuda, seed=6)
    _, want = attention_ref(q, k, v, causal=causal, return_lse=True)
    for blk_q, blk_k in tiles(dtype, dims[-1]):
        before = flash_attention.launches
        o, lse = flash_attention_with_lse(q, k, v, causal=causal,
                                          blk_q=blk_q, blk_k=blk_k)
        torch.cuda.synchronize()
        assert flash_attention.launches == before + 1
        assert lse.dtype == torch.float32 and lse.shape == want.shape
        torch.testing.assert_close(lse, want, rtol=LSE_TOL, atol=LSE_TOL)
        assert torch.equal(o, flash_attention(q, k, v, causal=causal,
                                              blk_q=blk_q, blk_k=blk_k))


def _wgmma_forward_at_other_lengths(D, causal, device):
    """bf16 at D on the wgmma kernel at both tiles, GQA 6 over 2, Sq = 256
    against Sk = 320 (a multiple of 64, not of 128: BK = 128 refuses it
    and runs at Sk = 256): o within bf16's tolerance of attention_ref, lse
    within LSE_TOL, one launch a call."""
    q, k, v = _qkv(2, 256, 320, 6, 2, D, torch.bfloat16, device, seed=9)
    assert tiles(torch.bfloat16, D) == ((128, 64), (128, 128))
    with pytest.raises(ValueError, match="multiples of the tiles"):
        flash_attention(q, k, v, causal=causal, blk_q=128, blk_k=128)
    tol = FLASH_TOL[torch.bfloat16]
    for blk_q, blk_k in tiles(torch.bfloat16, D):
        sk = 320 if 320 % blk_k == 0 else 256
        kk, vv = k[:, :sk].contiguous(), v[:, :sk].contiguous()
        want, want_lse = attention_ref(q, kk, vv, causal=causal,
                                       return_lse=True)
        before = flash_attention.launches
        o, lse = flash_attention_with_lse(q, kk, vv, causal=causal,
                                          blk_q=blk_q, blk_k=blk_k)
        torch.cuda.synchronize()
        assert flash_attention.launches == before + 1
        assert o.shape == q.shape and bool(torch.isfinite(o).all())
        torch.testing.assert_close(o.float(), want.float(), rtol=tol,
                                   atol=tol)
        torch.testing.assert_close(lse, want_lse, rtol=LSE_TOL, atol=LSE_TOL)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "bidir"])
def test_flash_wgmma_forward_at_head_dim_96(cuda, no_tf32, causal):
    """D = 96: the second 64-column box half outside the tensor (zeros on
    a load, clipped on a store), P.V as m64n96k16."""
    _wgmma_forward_at_other_lengths(96, causal, cuda)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "bidir"])
def test_flash_wgmma_forward_at_head_dim_112(cuda, no_tf32, causal):
    """D = 112 (zamba2-7b): the second box three quarters inside the
    tensor, P.V as m64n112k16 reading six of the eight 16-byte chunks of
    V's second swizzle atom."""
    _wgmma_forward_at_other_lengths(112, causal, cuda)


def test_flash_attention_trains_at_head_dim_112(cuda, no_tf32):
    """zamba2-7b's head dim (112) under autograd on the card, bf16 at its
    shared block's full head count (32/32): the wgmma forward writes lse,
    the wgmma backward takes it, one launch each; the gradients within the
    bf16 tolerance of autograd through ``attention_ref`` on the same
    values in float32."""
    q, k, v = (t.requires_grad_(True) for t in
               _qkv(1, 256, 256, 32, 32, 112, torch.bfloat16, cuda, seed=4))
    do = _qkv(1, 256, 256, 32, 32, 112, torch.bfloat16, cuda, seed=5)[0]
    fwd, bwd = flash_attention.launches, flash_attention.bwd_launches
    got = torch.autograd.grad(flash_attention(q, k, v), (q, k, v), do)
    torch.cuda.synchronize()
    assert (flash_attention.launches - fwd,
            flash_attention.bwd_launches - bwd) == (1, 1)
    f = [t.detach().float().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(attention_ref(*f), f, do.float())
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and _rel_l2(g, w) <= 2e-2


@pytest.mark.parametrize("D", [64, 96, 112, 128])
def test_flash_wgmma_occupancy_is_counted(cuda, D):
    """Every wgmma instance answers the occupancy query: the shared bytes
    of its tiles (two q boxes and a two-stage K/V ring, 64-column boxes
    rounded up, 1024 of alignment) and at least one block an SM; a tile
    that is not compiled raises."""
    dp = 64 * -(-D // 64)
    for _, blk_k in tiles(torch.bfloat16, D):
        smem, blocks = wgmma_occupancy(D, blk_k)
        assert smem == 2 * 64 * dp * 2 + 4 * blk_k * dp * 2 + 1024
        assert blocks >= 1
    with pytest.raises(RuntimeError, match="no kernel compiled"):
        wgmma_occupancy(D, 32)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "bidir"])
@pytest.mark.parametrize("D", [64, 112, 128])
def test_flash_wgmma_backward_at_other_lengths(cuda, no_tf32, D, causal):
    """Sq = 192 (three 64-row q tiles, not a multiple of the forward's
    128) against Sk = 384 (three 128-key tiles), GQA 6 over 2: o and lse
    from attention_ref on the card."""
    from repro_torch.kernels.flash_attention import (attention_bwd_ref,
                                                     flash_attention_bwd)
    q, k, v = _qkv(2, 192, 384, 6, 2, D, torch.bfloat16, cuda, seed=7)
    do = _qkv(2, 192, 384, 6, 2, D, torch.bfloat16, cuda, seed=8)[0]
    o, lse = attention_ref(q, k, v, causal=causal, return_lse=True)
    got = flash_attention_bwd(q, k, v, o, do, lse=lse, causal=causal)
    torch.cuda.synchronize()
    want = attention_bwd_ref(q, k, v, o, do, causal=causal)
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        assert _rel_l2(g, w) <= BWD_TOL[torch.bfloat16]


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "bidir"])
def test_flash_wgmma_backward_at_112_clips_dq_at_the_head(cuda, no_tf32,
                                                          causal):
    """D = 112: dq's rows are 112 floats, and columns 112-127 of the
    kernel's second 64-column box would be the next head's first 16 (past
    the buffer at the last head).  A head's gradients run alone and as the
    last of Hq = Hkv = 2 are equal: two 128-key tiles give each dq element
    at most two float32 adds into zero, which commute, so equal is exact;
    and within bf16's tolerance of the plain version."""
    from repro_torch.kernels.flash_attention import (attention_bwd_ref,
                                                     flash_attention_bwd)
    q, k, v = _qkv(1, 256, 256, 2, 2, 112, torch.bfloat16, cuda, seed=10)
    do = _qkv(1, 256, 256, 2, 2, 112, torch.bfloat16, cuda, seed=11)[0]
    o, lse = flash_attention_with_lse(q, k, v, causal=causal)
    both = flash_attention_bwd(q, k, v, o, do, lse=lse, causal=causal)
    last = [t[:, :, 1:].contiguous() for t in (q, k, v, o, do)]
    alone = flash_attention_bwd(*last, lse=lse[:, 1:].contiguous(),
                                causal=causal)
    torch.cuda.synchronize()
    for g2, g1 in zip(both, alone):
        assert torch.equal(g2[:, :, 1:], g1)
    want = attention_bwd_ref(q, k, v, o, do, causal=causal)
    for g, w in zip(both, want):
        assert _rel_l2(g, w) <= BWD_TOL[torch.bfloat16]


def test_flash_wgmma_backward_refuses_what_it_does_not_take(cuda):
    """bf16 at D = 64, 112, 128 needs Sk a multiple of 128 (the SIMT
    kernel's 64 is not taken instead), the forward's lse, and aligned
    tensors."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    before = flash_attention.bwd_launches
    for D in (64, 112):
        q, k, v = _qkv(1, 192, 192, 2, 1, D, torch.bfloat16, cuda)
        o, lse = attention_ref(q, k, v, return_lse=True)
        with pytest.raises(ValueError, match="multiples of 64 and 128"):
            flash_attention_bwd(q, k, v, o, q, lse=lse)
    q, k, v = _qkv(1, 256, 256, 2, 1, 64, torch.bfloat16, cuda)
    o, lse = flash_attention_with_lse(q, k, v)
    with pytest.raises(ValueError, match="lse"):
        flash_attention_bwd(q, k, v, o, q)
    with pytest.raises(ValueError, match="lse must be"):
        flash_attention_bwd(q, k, v, o, q, lse=lse[:, :, :128])
    shifted = torch.empty(q.numel() + 1, dtype=q.dtype, device=cuda)
    shifted[1:].copy_(q.flatten())
    with pytest.raises(ValueError, match="aligned"):
        flash_attention_bwd(shifted[1:].view(q.shape), k, v, o, q, lse=lse)
    assert flash_attention.bwd_launches == before


# ----------------------------------------------------------------------
# linear_scan
# ----------------------------------------------------------------------

# tests/test_kernels.py's limits: float32 sums in another order behind the
# two-sided exp(+-P) factors (1e-3); bf16 inputs and outputs (5e-2)
SCAN_TOL = {torch.float32: 1e-3, torch.bfloat16: 5e-2}
SCAN_SHAPES = [  # (B, T, H, K, V, post, use_u, chunk)
    (2, 128, 2, 32, 32, False, True, 32),    # RWKV-6 shape of test_kernels
    (2, 128, 2, 16, 48, True, False, 64),    # K != V, a partial V slice
    (2, 37, 2, 16, 24, False, True, 64),     # odd c = T = 37
    (1, 512, 1, 64, 64, False, True, 256),   # the model's chunk, clamped
    (1, 64, 2, 64, 64, False, True, 64),     # a single chunk, T = c = 64
    (2, 2048, 2, 64, 64, False, True, 64),   # 32 chunks handed off, weak decay
    (2, 128, 2, 32, 96, True, False, 64),    # post-update, V = 96: two slices
    (2, 256, 2, 16, 64, False, True, 128),   # K = 16, two query tiles a chunk
]
# shapes drawn with a weak decay (log_w * 0.01) so that the state handed
# from chunk to chunk carries most of o, as chip_smoke.py's HANDOFF_SCAN
WEAK_DECAY = {(2, 2048, 2, 64, 64, False, True, 64)}


def _scan_inputs(B, T, H, K, V, use_u, dtype, device, seed=0, decay=0.5):
    g = torch.Generator(device=device).manual_seed(seed)

    def n(*shape):
        return torch.randn(shape, generator=g, device=device)
    r, k, v = n(B, T, H, K).to(dtype), n(B, T, H, K).to(dtype), \
        n(B, T, H, V).to(dtype)
    lw = -n(B, T, H, K).abs() * decay
    u = n(H, K) if use_u else None
    return r, k, v, lw, u, n(B, H, K, V)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SCAN_SHAPES, ids=str)
def test_linear_scan_kernel_matches_plain(cuda, no_tf32, shape, dtype):
    *dims, post, use_u, chunk = shape
    r, k, v, lw, u, s0 = _scan_inputs(
        *dims, use_u, dtype, cuda,
        decay=0.01 if shape in WEAK_DECAY else 0.5)
    o, s = linear_scan(r, k, v, lw, u, s0, chunk=chunk, post_update=post)
    torch.cuda.synchronize()
    want_o, want_s = linear_scan_ref(r, k, v, lw, u=u, state0=s0,
                                     chunk=chunk, post_update=post)
    assert o.dtype == dtype and s.dtype == torch.float32
    tol = SCAN_TOL[dtype]
    torch.testing.assert_close(o.float(), want_o, rtol=tol, atol=tol)
    torch.testing.assert_close(s, want_s, rtol=tol, atol=tol)


def test_linear_scan_counts_launches_and_rejects_bad_inputs(cuda):
    r, k, v, lw, u, s0 = _scan_inputs(1, 64, 2, 16, 16, True, torch.float32,
                                      cuda)
    before = linear_scan.launches
    o, _ = linear_scan(r, k, v, lw, u, s0, chunk=16)
    assert linear_scan.launches == before + 1
    # strided inputs are taken, as their contiguous copies
    strided, _ = linear_scan(r.transpose(1, 2).contiguous().transpose(1, 2),
                             k, v, lw, u, s0, chunk=16)
    torch.testing.assert_close(strided, o, rtol=0, atol=0)
    before += 1
    linear_scan(r.cpu(), k.cpu(), v.cpu(), lw.cpu())  # the plain path
    assert linear_scan.launches == before + 1
    # three passes (state, hand-off, output), over several chunks and two
    # 64-column slices of V: still one launch a call
    r2, k2, v2, lw2, u2, s2 = _scan_inputs(1, 256, 2, 16, 96, True,
                                           torch.float32, cuda)
    linear_scan(r2, k2, v2, lw2, u2, s2, chunk=64)
    assert linear_scan.launches == before + 2
    before += 1
    with pytest.raises(ValueError, match="device"):
        linear_scan(r, k.cpu(), v, lw)
    with pytest.raises(ValueError, match="chunks"):
        linear_scan(*(torch.cat([t] * 8, 1) for t in (r, k, v, lw)),
                    chunk=512)
    with pytest.raises(ValueError, match="K <= 64"):
        w = torch.zeros(1, 8, 1, 128, device=cuda)
        linear_scan(w, w, w, w)
    # under grad: the forward kernel once, and the backward kernel once
    rg = r.detach().clone().requires_grad_(True)
    b0 = linear_scan_bwd.launches
    o, _ = linear_scan(rg, k, v, lw)
    assert linear_scan.launches == before + 2
    torch.autograd.grad((o * o).sum(), rg)
    assert linear_scan_bwd.launches == b0 + 1


def test_rwkv_forward_launches_linear_scan_once_per_layer(cuda):
    cfg = REGISTRY["rwkv6-1.6b"].reduced()
    params = init_params(registry.specs(cfg), 0, cuda)
    toks = torch.zeros((2, 32), dtype=torch.int32, device=cuda)
    before = linear_scan.launches
    with torch.no_grad():
        loss = registry.loss_fn(params, {"tokens": toks, "labels": toks},
                                cfg)
        _, cache = registry.prefill(params, {"tokens": toks}, cfg, 40)
        mid = linear_scan.launches
        registry.decode_step(params, {"tokens": toks[:, :1]}, cache, cfg)
    assert np.isfinite(float(loss))
    assert mid == before + 2 * cfg.n_layers
    assert linear_scan.launches == mid  # decode runs the per-token step


def test_hybrid_forward_launches_its_kernels(cuda):
    """Reduced zamba2-7b (4 Mamba-2 layers, the shared block twice) at
    S = 128: the full-sequence forward launches linear_scan once a layer
    and flash_attention once a shared-block application; the prefill the
    scan alone (its attention fills the cache on the plain path); decode
    neither."""
    from repro_torch.models.transformer import n_attn_apps
    cfg = REGISTRY["zamba2-7b"].reduced()
    params = init_params(registry.specs(cfg), 0, cuda)
    toks = torch.zeros((2, 128), dtype=torch.int32, device=cuda)

    def counts():
        return np.array([linear_scan.launches, flash_attention.launches])
    with torch.no_grad():
        c0 = counts()
        loss = registry.loss_fn(params, {"tokens": toks, "labels": toks},
                                cfg)
        c1 = counts()
        _, cache = registry.prefill(params, {"tokens": toks}, cfg, 136)
        c2 = counts()
        registry.decode_step(params, {"tokens": toks[:, :1]}, cache, cfg)
        c3 = counts()
    assert np.isfinite(float(loss))
    assert list(c1 - c0) == [cfg.n_layers, n_attn_apps(cfg)]
    assert list(c2 - c1) == [cfg.n_layers, 0]
    assert list(c3 - c2) == [0, 0]


# ----------------------------------------------------------------------
# Training on the card (repro_torch.training, checkpoint)
# ----------------------------------------------------------------------

def test_dense_train_step_on_card_matches_cpu(cuda, no_tf32):
    """Reduced llama3-8b (GQA 4 over 2) at S = 128, where the attention
    takes the kernels: full remat runs each layer's forward twice and the
    backward once; the float32 step equals the CPU step (the plain
    attention under autograd) within float32 sums."""
    from repro_torch.data import batch_for_step
    from repro_torch.optim import adamw
    from repro_torch.training import TrainConfig, make_train_step
    from repro_torch.tree import leaves
    cfg = REGISTRY["llama3-8b"].reduced().replace(n_kv_heads=2,
                                                  dtype=torch.float32)
    batch = batch_for_step(0, global_batch=2, seq=128, vocab=cfg.vocab)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        params = _f32(init_params(registry.specs(cfg), 0, "cpu"), dev)
        tc = TrainConfig(opt=adamw.AdamWConfig(warmup_steps=1))
        step = make_train_step(cfg, tc, device=dev)
        fwd, bwd = flash_attention.launches, flash_attention.bwd_launches
        params, _, m = step(params, adamw.init_state(params), batch)
        out[dev.type] = (float(m["loss"]), float(m["grad_norm"]),
                         [p.detach().cpu() for p in leaves(params)])
        if dev.type == "cuda":
            assert flash_attention.launches - fwd == 2 * cfg.n_layers
            assert flash_attention.bwd_launches - bwd == cfg.n_layers
    (lc, gc, pc), (lp, gp, pp) = out["cuda"], out["cpu"]
    assert abs(lc - lp) <= 1e-5 * abs(lp)
    assert abs(gc - gp) <= 1e-4 * abs(gp)
    for a, b in zip(pc, pp):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def _f32(tree, dev):
    return {k: _f32(v, dev) if isinstance(v, dict) else
            v.to(dev, torch.float32) for k, v in tree.items()}


def test_rwkv_train_step_on_card_matches_cpu(cuda, no_tf32):
    """Reduced rwkv6-1.6b (chunk 16) at S = 64 in float32: full remat runs
    each layer's linear_scan forward twice and its backward kernel once;
    the step's loss and grad_norm equal the CPU step's (linear_scan_bwd_ref)
    within float32 sums, and so does every gradient of ``loss_fn`` (rel L2
    1e-4).  The updated params are not compared: AdamW's first step is
    g / (|g| + eps), which turns a rounding of a gradient near eps into a
    change of the update's size."""
    from repro_torch.data import batch_for_step
    from repro_torch.optim import adamw
    from repro_torch.training import TrainConfig, make_train_step
    from repro_torch.tree import leaves
    cfg = REGISTRY["rwkv6-1.6b"].reduced().replace(dtype=torch.float32)
    batch = batch_for_step(0, global_batch=2, seq=64, vocab=cfg.vocab)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        params = _f32(init_params(registry.specs(cfg), 0, "cpu"), dev)
        flat = leaves(params)
        for p in flat:
            p.requires_grad_(True)
        tb = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        bwd = linear_scan_bwd.launches
        grads = torch.autograd.grad(registry.loss_fn(params, tb, cfg), flat)
        tc = TrainConfig(opt=adamw.AdamWConfig(warmup_steps=1))
        step = make_train_step(cfg, tc, device=dev)
        fwd = linear_scan.launches
        _, _, m = step(params, adamw.init_state(params), batch)
        out[dev.type] = (float(m["loss"]), float(m["grad_norm"]),
                         [g.cpu() for g in grads])
        if dev.type == "cuda":
            assert linear_scan.launches - fwd == 2 * cfg.n_layers
            assert linear_scan_bwd.launches - bwd == 2 * cfg.n_layers
    (lc, gc, dc), (lp, gp, dp) = out["cuda"], out["cpu"]
    assert abs(lc - lp) <= 1e-5 * abs(lp)
    assert abs(gc - gp) <= 1e-4 * abs(gp)
    for a, b in zip(dc, dp):
        assert _rel_l2(a, b) <= 1e-4


def test_hybrid_train_step_on_card_matches_cpu(cuda, no_tf32):
    """Reduced zamba2-7b with the shared block at head dim 112 (zamba2's
    own), 5 layers (two groups of 2 and a tail layer), S = 128 in float32:
    the attention takes the flash kernels, the Mamba-2 layers the scan
    kernels; full remat runs every forward twice and each backward once.
    The step's loss and grad_norm and every gradient of ``loss_fn`` equal
    the CPU's (the plain versions under autograd) within float32 sums."""
    from repro_torch.data import batch_for_step
    from repro_torch.models.transformer import n_attn_apps
    from repro_torch.optim import adamw
    from repro_torch.training import TrainConfig, make_train_step
    from repro_torch.tree import leaves
    cfg = REGISTRY["zamba2-7b"].reduced().replace(
        n_layers=5, head_dim=112, dtype=torch.float32)
    apps = n_attn_apps(cfg)
    batch = batch_for_step(0, global_batch=2, seq=128, vocab=cfg.vocab)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        params = _f32(init_params(registry.specs(cfg), 0, "cpu"), dev)
        flat = leaves(params)
        for p in flat:
            p.requires_grad_(True)
        tb = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        grads = torch.autograd.grad(registry.loss_fn(params, tb, cfg), flat)
        counts = (flash_attention.launches, flash_attention.bwd_launches,
                  linear_scan.launches, linear_scan_bwd.launches)
        step = make_train_step(cfg, TrainConfig(
            opt=adamw.AdamWConfig(warmup_steps=1)), device=dev)
        _, _, m = step(params, adamw.init_state(params), batch)
        out[dev.type] = (float(m["loss"]), float(m["grad_norm"]),
                         [g.cpu() for g in grads])
        if dev.type == "cuda":
            got = (flash_attention.launches, flash_attention.bwd_launches,
                   linear_scan.launches, linear_scan_bwd.launches)
            assert tuple(a - b for a, b in zip(got, counts)) == (
                2 * apps, apps, 2 * cfg.n_layers, cfg.n_layers)
    (lc, gc, dc), (lp, gp, dp) = out["cuda"], out["cpu"]
    assert abs(lc - lp) <= 1e-5 * abs(lp)
    assert abs(gc - gp) <= 1e-4 * abs(gp)
    for a, b in zip(dc, dp):
        assert _rel_l2(a, b) <= 1e-4


def test_moe_layer_on_card_is_repeatable_and_matches_cpu(cuda, no_tf32):
    """``apply_moe`` of reduced dbrx-132b at capacity factor 0.5 (tokens
    overflow into the sentinel slot, whose index_add_ order varies): two
    calls on the card bit-identical in bf16, and the float32 layer equal
    to the CPU's within float32 sums."""
    from repro_torch.models import moe
    cfg = REGISTRY["dbrx-132b"].reduced().replace(capacity_factor=0.5)
    p = {k: v[0] for k, v in init_params(moe.moe_specs(cfg, 1), 0,
                                         "cpu").items()}
    x = torch.randn((2, 64, cfg.d_model),
                    generator=torch.Generator().manual_seed(0))
    pc = {k: v.to(cuda) for k, v in p.items()}
    a, b = (moe.apply_moe(pc, x.to(cuda, torch.bfloat16), cfg)
            for _ in range(2))
    assert torch.equal(a, b)
    f32 = cfg.replace(dtype=torch.float32)
    got = moe.apply_moe({k: v.float() for k, v in pc.items()}, x.to(cuda),
                        f32)
    want = moe.apply_moe({k: v.float() for k, v in p.items()}, x, f32)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)


# (B, T, H, K, V, post, use_u, chunk): rwkv6's form at the model's chunk,
# T = c, c < 64 (odd), K < 64 with V > 64 (several V slices), post-update
# (Mamba-2), a chunk of 48 with K = 48 and V = 80; K = 20, not a multiple
# of the tensor-core fragments' 8 (zero-padded to 24), with V = 96 and with
# V = 90 (not a multiple of 4: the slices load element by element)
SCAN_BWD_SHAPES = [(1, 512, 2, 64, 64, False, True, 256),
                   (2, 64, 2, 16, 16, False, True, 64),
                   (2, 37, 2, 16, 24, False, True, 64),
                   (1, 512, 2, 32, 96, True, False, 256),
                   (2, 256, 3, 64, 64, True, False, 64),
                   (2, 96, 2, 48, 80, False, True, 48),
                   (2, 128, 2, 20, 96, False, True, 64),
                   (1, 192, 2, 20, 90, True, False, 96)]
# rel L2 of each gradient against linear_scan_bwd_ref on the same inputs:
# float32 sums in another order behind the exp(+-P) factors (1e-4); bf16
# inputs against the float32 formulas on the same rounded values (1e-2)
SCAN_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


def _scan_bwd_case(shape, dtype, device, state=True):
    *dims, post, use_u, chunk = shape
    B, T, H, K, V = dims
    r, k, v, lw, u, s0 = _scan_inputs(*dims, use_u, dtype, device, seed=4,
                                      decay=0.3)
    lw.view(-1)[::11] = -120.0 / min(chunk, T)  # below the -60/c clamp
    g = torch.Generator(device=device).manual_seed(5)
    do = torch.randn((B, T, H, V), generator=g, device=device).to(dtype)
    dS = torch.randn((B, H, K, V), generator=g, device=device)
    return (r, k, v, lw, u, s0 if state else None, do,
            dS if state else None), chunk, post


@pytest.mark.parametrize("state", [True, False], ids=["state", "nostate"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SCAN_BWD_SHAPES, ids=str)
def test_linear_scan_backward_kernel_matches_plain(cuda, no_tf32, shape,
                                                   dtype, state):
    ins, chunk, post = _scan_bwd_case(shape, dtype, cuda, state)
    r, k, v, lw, u, s0, do, dS = ins
    _, _, states = linear_scan_with_states(r, k, v, lw, u, s0, chunk=chunk,
                                           post_update=post)
    before = linear_scan_bwd.launches
    got = linear_scan_bwd(*ins, chunk=chunk, post_update=post,
                          states=states)
    again = linear_scan_bwd(*ins, chunk=chunk, post_update=post,
                            states=states)
    torch.cuda.synchronize()
    assert linear_scan_bwd.launches == before + 2
    want = linear_scan_bwd_ref(*(None if t is None else t.float()
                                 for t in ins), chunk=chunk,
                               post_update=post)
    for i, (g, w) in enumerate(zip(got, want)):
        assert (g is None) == (w is None)
        if g is None:
            continue
        assert g.dtype == (dtype if i < 3 else torch.float32)
        assert bool(torch.isfinite(g).all())
        assert torch.equal(g, again[i])  # no atomics: the same bits
        assert _rel_l2(g, w) <= SCAN_BWD_TOL[dtype], i
    lo = float(np.float32(-60.0 / min(chunk, r.shape[1])))
    assert bool((got[3][lw < lo] == 0).all())


def test_linear_scan_backward_trains_and_refuses_bad_inputs(cuda, no_tf32):
    """Autograd through linear_scan on the card equals the plain version's
    autograd; the backward needs the forward's states and a do in r's
    dtype; double backward raises."""
    ins, chunk, post = _scan_bwd_case((2, 128, 2, 32, 32, False, True, 32),
                                      torch.float32, cuda)
    r, k, v, lw, u, s0, do, dS = ins
    req = [t.clone().requires_grad_(True) for t in (r, k, v, lw, u, s0)]
    o, s = linear_scan(*req, chunk=chunk)
    got = torch.autograd.grad((o, s), req, (do, dS))
    ref = [t.clone().requires_grad_(True) for t in (r, k, v, lw, u, s0)]
    o2, s2 = linear_scan_ref(*ref, chunk=chunk)
    want = torch.autograd.grad((o2, s2), ref, (do, dS))
    for g, w in zip(got, want):
        assert _rel_l2(g, w) <= 1e-4
    with pytest.raises(ValueError, match="states"):
        linear_scan_bwd(*ins, chunk=chunk)
    with pytest.raises(ValueError, match="do must be"):
        linear_scan_bwd(r, k, v, lw, u, s0, do.bfloat16(), chunk=chunk)
    o, _ = linear_scan(*req, chunk=chunk)
    dr, = torch.autograd.grad((o * o).sum(), req[0], create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable"):
        dr.sum().backward()


def test_checkpoint_round_trip_on_card(cuda, tmp_path):
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.training import TrainConfig, init_train_state
    from repro_torch.tree import leaves
    cfg = REGISTRY["olmo-1b"].reduced()
    state = init_train_state(cfg, TrainConfig(), 0, cuda)
    ck = Checkpointer(str(tmp_path), keep=1)
    ck.save(1, state, async_save=True)
    restored, manifest = ck.restore(state, device=cuda)
    assert manifest["step"] == 1
    for a, b in zip(leaves(state), leaves(restored)):
        assert b.device.type == "cuda" and a.dtype == b.dtype
        assert torch.equal(a.detach(), b)


# ----------------------------------------------------------------------
# The mapping search on the card (repro_torch.mapspace)
# ----------------------------------------------------------------------

def _search_case():
    from repro_torch import mapspace
    op = tensor_analysis.conv2d("gene-conv", k=8, c=6, y=12, x=12, r=3, s=3)
    space = mapspace.build_space(op, dims=("K", "C", "Y"),
                                 cluster_sizes=(8,), perm_mode="all")
    return mapspace, op, space


def _same_search(a, b):
    assert a.strategy == b.strategy and a.n_evaluated == b.n_evaluated
    assert a.best_point == b.best_point
    assert [e["point"] for e in a.top_k] == [e["point"] for e in b.top_k]
    for ea, eb in zip(a.top_k, b.top_k):
        assert ea["value"] == pytest.approx(eb["value"], rel=1e-6)
        for k, v in eb["stats"].items():
            assert ea["stats"][k] == pytest.approx(v, rel=1e-6), k


@pytest.mark.parametrize("strategy", ["exhaustive", "greedy"])
def test_search_on_cuda_matches_cpu(cuda, strategy):
    mapspace, op, space = _search_case()
    kw = dict(objective="edp", budget=10_000 if strategy == "exhaustive"
              else 150, space=space, num_pes=48, noc_bw=12.0,
              strategy=strategy, seed=0, block=64)
    on_card = mapspace.search(op, **kw)          # cuda by default
    _same_search(on_card, mapspace.search(op, device="cpu", **kw))
    legacy = mapspace.search(op, pipeline="legacy", **kw)
    _same_search(legacy, on_card)


def _same_answer(a, b):
    _same_search(a, b)
    assert a.best_value == b.best_value
    assert [e["value"] for e in a.top_k] == [e["value"] for e in b.top_k]


SEARCH_KW = dict(objective="edp", budget=120, num_pes=48, noc_bw=12.0,
                 strategy="greedy", seed=5, block=32)


def test_search_stripes_two_shards_on_one_card(cuda, monkeypatch):
    """The striping over cards (per-shard row offsets, an event per
    shard, the (value, global index) merge), run with two shards on
    card 0 so that it runs on a one-card machine too."""
    from repro_torch.mapspace import universal
    mapspace, op, space = _search_case()
    one = mapspace.search(op, devices=1, space=space, **SEARCH_KW)
    assert one.n_devices == 1
    monkeypatch.setattr(universal, "_devices", lambda device, n_devices:
                        [torch.device("cuda", 0)] * 2)
    two = mapspace.search(op, space=space, **SEARCH_KW)
    assert two.n_devices == 2
    _same_answer(two, one)


def test_search_gives_the_same_answer_on_one_and_two_cards(cuda):
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip(f"{n} CUDA device: striping over cards needs two")
    mapspace, op, space = _search_case()
    one = mapspace.search(op, devices=1, space=space, **SEARCH_KW)
    for nd in sorted({2, n}):
        many = mapspace.search(op, devices=nd, space=space, **SEARCH_KW)
        assert many.n_devices == nd
        _same_answer(many, one)


# ----------------------------------------------------------------------
# The front door on the card (repro_torch.api)
# ----------------------------------------------------------------------

FRONT_DOOR_QUERIES = [
    {"workload": {"op": {"type": "conv2d", "name": "fd-conv", "k": 8,
                         "c": 6, "y": 12, "x": 12, "r": 3, "s": 3}},
     "hardware": {"num_pes": 48, "noc_bw": 12.0},
     "search": {"objective": "edp", "budget": 150, "block": 64,
                "top_k": 4}},
    {"workload": {"op": {"type": "conv2d", "name": "fd-conv", "k": 8,
                         "c": 6, "y": 12, "x": 12, "r": 3, "s": 3}},
     "hardware": {"num_pes": 48, "noc_bw": 12.0,
                  "pe_range": [16, 32, 64], "bw_range": [4.0, 8.0, 16.0]},
     "search": {"objective": "edp", "budget": 80, "block": 64,
                "top_k": 4, "codse_top_k": 2, "joint_genes": 16}},
]


@pytest.mark.parametrize("d", FRONT_DOOR_QUERIES,
                         ids=["layer", "layer_codse"])
def test_session_on_cuda_matches_cpu(cuda, d):
    """``Session.run`` on the card (its default) and on the CPU: the same
    report but for the timings (points identical, values at rtol 1e-6,
    top-k swaps only within 1e-6 ties)."""
    from repro_torch.api import Query, Session
    from torch_scripts import load_script
    fx = load_script("make_front_door_fixture")
    q = Query.from_json(d)
    on_card = Session().run(q)
    on_cpu = Session(device="cpu").run(q)
    assert on_card.kind == q.kind
    fx.compare_reports(on_card.to_json(), on_cpu.to_json())


def test_bench_provenance_is_the_runs_device(cuda):
    """On a host with a card, a CPU run's artifact says ``cpu`` and a card
    run's names the card."""
    from repro_torch.api import Report
    on_card = Report.bench("x", {}).to_json()["environment"]
    assert on_card["backend"] == "cuda"
    assert on_card["device_kind"] == torch.cuda.get_device_name(0)
    assert on_card["device_count"] == torch.cuda.device_count()
    on_cpu = Report.bench("x", {}, device="cpu").to_json()["environment"]
    assert on_cpu["backend"] == "cpu" and on_cpu["device_kind"] == "cpu"


# ----------------------------------------------------------------------
# Network queries and run_many on the card (repro_torch.netspace)
# ----------------------------------------------------------------------

NET_QUERY = {
    "workload": {"layers": [
        {"type": "conv2d", "name": "net-c1", "k": 8, "c": 4, "y": 12,
         "x": 12, "r": 3, "s": 3},
        {"type": "conv2d", "name": "net-c2", "k": 12, "c": 8, "y": 14,
         "x": 14, "r": 3, "s": 3},
        {"type": "fc", "name": "net-f1", "k": 16, "c": 32}]},
    "hardware": {"num_pes": 48, "noc_bw": 12.0, "reconfig_latency": 100.0},
    "search": {"objective": "edp", "budget": 150, "block": 64,
               "frontier_k": 3, "l2_budget_kb": 60.0,
               "budget_policy": "uniform"}}
BATCH = [
    {"workload": {"op": op},
     "hardware": {"num_pes": 32 + 16 * (i % 2), "noc_bw": 8.0 + 4 * (i % 3)},
     "search": {"objective": obj, "budget": 50, "block": 32, "top_k": 3}}
    for i, (op, obj) in enumerate(zip(
        NET_QUERY["workload"]["layers"] + [
            {"type": "gemm", "name": "b-g1", "m": 8, "n": 24, "k": 16}],
        ["edp", "energy", "throughput", "runtime"]))]


def _network_queries():
    from repro_torch.api import Query
    net = Query.from_json(NET_QUERY)
    grid = Query.from_json(dict(NET_QUERY, hardware=dict(
        NET_QUERY["hardware"], pe_range=[16, 32, 64],
        bw_range=[4.0, 8.0, 16.0])))
    return net, grid, [Query.from_json(d) for d in BATCH]


def test_network_queries_and_run_many_on_cuda_match_cpu(cuda):
    """``network``, ``network_codse`` and a coalesced ``run_many`` batch
    on the card (the session's default) and on the CPU: the same reports
    but for the timings."""
    from repro_torch.api import Session
    from torch_scripts import load_script
    fx = load_script("make_front_door_fixture")
    net, grid, batch = _network_queries()
    card, cpu = Session(), Session(device="cpu")
    for q in (net, grid):
        fx.compare_reports(card.run(q).to_json(), cpu.run(q).to_json())
    for a, b in zip(card.run_many(batch), cpu.run_many(batch)):
        assert a.coalesced and b.coalesced
        fx.compare_reports(a.to_json(), b.to_json())


def test_netspace_stripes_two_shards_on_one_card(cuda, monkeypatch):
    """The evaluator's striping (per-shard operand copies, an event per
    shard, per-row outputs), run with two shards on card 0 so that it
    runs on a one-card machine too: the same answers as one shard."""
    from repro_torch.api import Session
    from repro_torch.netspace import evaluator
    net, _, batch = _network_queries()
    one = Session(devices=1)
    want = [one.run(net).results_json()] + \
        [r.results_json() for r in one.run_many(batch)]
    monkeypatch.setattr(evaluator, "_devices", lambda device, n_devices:
                        [torch.device("cuda", 0)] * 2)
    two = Session()
    rep = two.run(net)
    assert rep.n_devices == 2
    reps = two.run_many(batch)
    assert two.last_batch["n_devices"] == 2
    assert [rep.results_json()] + [r.results_json() for r in reps] == want


SERVE_FIXTURE = "tests/data/torch_serve_fixture.json"


def test_server_flush_on_the_card_equals_the_serve_fixture(cuda, tmp_path):
    """The serving tier on the card: a ``DSEServer`` whose session names
    ``cuda:0`` (the flush worker makes it its thread's current device)
    answers ``tests/test_serve.py``'s three queries in one flush as the
    JAX package's ``execute_batch`` (the committed serve fixture), and a
    session that names no device serves from the card too."""
    import asyncio
    import json
    from repro_torch.api import Session
    from repro_torch.serve import DSEServer, ServeConfig, http_json
    from torch_scripts import ROOT, load_script
    fx = load_script("make_front_door_fixture")
    case = json.loads((ROOT / SERVE_FIXTURE).read_text())["cases"]["serve"]

    async def flush(session):
        srv = DSEServer(session, ServeConfig(
            port=0, exit_on_kill=False, max_batch=len(case["queries"]),
            flush_interval_s=30.0, flight_dir=str(tmp_path)))
        await srv.start()
        try:
            return await asyncio.wait_for(asyncio.gather(*(http_json(
                "127.0.0.1", srv.port, "POST", "/query", q, timeout=120)
                for q in case["queries"])), timeout=180)
        finally:
            await srv.stop()
    for session in (Session(cache_dir=None, device="cuda:0"),
                    Session(cache_dir=None)):
        assert DSEServer(session).device.type == "cuda"
        res = asyncio.run(flush(session))
        assert [st for st, _ in res] == [200] * len(res)
        for (_, body), want in zip(res, case["reports"]):
            fx.compare_reports(body, want)


def test_graph_audit_on_the_card(cuda):
    """The graph audit of the 16 universal evaluator cases on the card:
    no host sync, and every synchronisation that sync debug mode flags in
    a chunk lies at a site the audit names as making a host tensor (each
    such tensor is a pageable host-to-device copy)."""
    from repro_torch.analysis import graph_audit
    findings, report = graph_audit.audit(cuda)
    assert report["device"] == "cuda" and report["n_cases"] == 16
    assert not [f.one_line() for f in findings if f.code == "TORCH-SYNC"]
    named = {f.site for f in findings if f.code == "TORCH-H2D"}
    assert named
    for name, rec in report["cases"].items():
        assert set(rec["syncs"]) <= named, name
        assert rec["kernels"] > 0, name
