"""Port of the flash attention kernel module against the JAX package's: the
plain PyTorch ``attention_ref`` against the Pallas kernel (interpret mode)
and the JAX ``attention_ref`` on the shapes of ``tests/test_kernels.py``,
the bf16 wgmma kernel's arithmetic (P rounded to bf16) written out in
PyTorch against the Pallas kernel, ``ops.attention`` on CPU tensors, and the
wrapper's input checks and per-(dtype, head dim) tiles.  The CUDA kernels
themselves run only on the card (``tests/test_torch_cuda.py``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import attention_ref as j_ref  # noqa: E402
from repro.kernels.flash_attention import \
    flash_attention as j_flash  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    attention, attention_ref, flash_attention)
from repro_torch.kernels.flash_attention.flash_attention import (  # noqa: E402
    SIMT_TILES, WGMMA_TILES, tiles)

SHAPES = [  # tests/test_kernels.py:19-28
    (1, 128, 128, 2, 2, 64, True),
    (2, 256, 256, 4, 1, 64, True),     # MQA
    (1, 256, 256, 8, 2, 128, True),    # GQA group 4
    (2, 128, 128, 2, 2, 64, False),    # bidirectional (encoder)
    (1, 512, 512, 2, 2, 64, True),     # multiple k blocks
]
# tests/test_kernels.py's tolerances: float32 sums in another order (2e-6);
# bf16 outputs round to 8 bits of mantissa (2e-2)
TOL = {"float32": 2e-6, "bfloat16": 2e-2}


def _inputs(B, Sq, Sk, Hq, Hkv, D, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, Hq, D)).astype(np.float32),
            rng.standard_normal((B, Sk, Hkv, D)).astype(np.float32),
            rng.standard_normal((B, Sk, Hkv, D)).astype(np.float32))


def _both(arrays, dtype: str):
    """The same values in both packages; bf16 rounds the same float32
    numbers to nearest even on both sides."""
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    td = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    return ([jnp.asarray(a).astype(jd) for a in arrays],
            [torch.from_numpy(a).to(td) for a in arrays])


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D,causal", SHAPES)
def test_ref_matches_pallas_interpret_and_jax_ref(B, Sq, Sk, Hq, Hkv, D,
                                                  causal, dtype):
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(B, Sq, Sk, Hq, Hkv, D),
                                       dtype)
    got = attention_ref(tq, tk, tv, causal=causal)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    tol = TOL[dtype]
    kernel = j_flash(jq, jk, jv, causal=causal, blk_q=128, blk_k=128,
                     interpret=True)
    np.testing.assert_allclose(_f32(got), _f32(kernel), atol=tol, rtol=tol)
    ref = j_ref(jq, jk, jv, causal=causal)
    np.testing.assert_allclose(_f32(got), _f32(ref), atol=tol, rtol=tol)


@pytest.mark.parametrize("causal", [True, False])
def test_ops_attention_runs_where_cpu_tensors_lie(causal):
    _, (q, k, v) = _both(_inputs(1, 128, 128, 8, 2, 32, seed=1), "float32")
    before = flash_attention.launches
    out = attention(q, k, v, causal=causal)
    assert out.device.type == "cpu"
    torch.testing.assert_close(out, attention_ref(q, k, v, causal=causal),
                               rtol=0, atol=0)
    assert flash_attention.launches == before  # the plain path launches none
    arrays = [t.numpy() for t in (q, k, v)]
    out2 = attention(*arrays, causal=causal, device="cpu")
    torch.testing.assert_close(out2, out, rtol=0, atol=0)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    _, (q, k, v) = _both(_inputs(1, 128, 128, 4, 2, 64), "float32")
    with pytest.raises(TypeError):
        flash_attention(q, k.to(torch.bfloat16), v)
    with pytest.raises(TypeError):
        flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(TypeError):
        flash_attention(q.numpy(), k, v)
    with pytest.raises(ValueError, match="head dim"):
        pad = torch.zeros(1, 128, 4, 32)
        flash_attention(*(torch.cat([t, pad[:, :, :t.shape[2]]], -1)
                          for t in (q, k, v)))           # D = 96
    with pytest.raises(ValueError, match="multiple of"):
        flash_attention(q, k[:, :, :1].expand(1, 128, 3, 64).contiguous(),
                        v[:, :, :1].expand(1, 128, 3, 64).contiguous())
    with pytest.raises(ValueError, match="multiples of the tiles"):
        flash_attention(q[:, :96].contiguous(), k, v)
    with pytest.raises(ValueError, match="tile"):
        flash_attention(q, k, v, blk_q=32, blk_k=32)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v)
    with pytest.raises(ValueError):
        flash_attention(q[0], k[0], v[0])
    with pytest.raises(ValueError, match="batch or head"):
        flash_attention(q, torch.cat([k, k]), torch.cat([v, v]))


def test_wrapper_refuses_inputs_that_need_a_gradient():
    """The wrapper refused such inputs until its backward landed; under
    grad it now differentiates them (on CPU tensors through
    ``attention_bwd_ref``, held in ``tests/test_torch_flash_backward.py``),
    and without grad it builds no graph."""
    _, (q, k, v) = _both(_inputs(1, 128, 128, 2, 2, 16), "float32")
    q.requires_grad_(True)
    out = flash_attention(q, k, v)
    assert out.requires_grad
    dq, = torch.autograd.grad(out.sum(), q)
    want, = torch.autograd.grad(attention_ref(q, k, v).sum(), q)
    torch.testing.assert_close(dq, want, rtol=1e-6, atol=1e-6)
    with torch.no_grad():
        out = flash_attention(q, k, v)
    assert not out.requires_grad
    torch.testing.assert_close(out, attention_ref(q.detach(), k, v),
                               rtol=0, atol=0)


def _online_bf16_p(q, k, v, causal: bool, blk_k: int) -> torch.Tensor:
    """The bf16 wgmma kernel's arithmetic, tile by tile in PyTorch: float32
    scores (products of bf16 values are exact in float32), the online
    softmax in base 2 with log2(e) folded into the scale, l summed from the
    float32 P, P rounded to bf16 before the P.V product, float32 m, l and
    acc, acc / max(l, 1e-30) rounded to bf16."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    qf = q.float().transpose(1, 2)                              # B Hq Sq D
    kf = k.float().repeat_interleave(Hq // Hkv, 2).transpose(1, 2)
    vf = v.float().repeat_interleave(Hq // Hkv, 2).transpose(1, 2)
    c = torch.tensor(np.float32(D ** -0.5) * np.float32(1.4426950408889634))
    m = torch.full((B, Hq, Sq), -1e30)
    l = torch.zeros(B, Hq, Sq)
    acc = torch.zeros(B, Hq, Sq, D)
    q_pos = torch.arange(Sq)[:, None]
    for k0 in range(0, Sk, blk_k):
        s = qf @ kf[:, :, k0:k0 + blk_k].transpose(-1, -2) * c
        if causal:
            s = torch.where(torch.arange(k0, k0 + blk_k)[None] <= q_pos, s,
                            -1e30)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new[..., None])
        l = alpha * l + p.sum(-1)
        acc = alpha[..., None] * acc + \
            p.bfloat16().float() @ vf[:, :, k0:k0 + blk_k]
        m = m_new
    return (acc / l.clamp(min=1e-30)[..., None]).transpose(1, 2) \
        .to(torch.bfloat16)


@pytest.mark.parametrize("blk_k", [64, 128])
@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D,causal", SHAPES)
def test_bf16_p_arithmetic_meets_the_pallas_tolerance(B, Sq, Sk, Hq, Hkv, D,
                                                      causal, blk_k):
    """Rounding P to bf16 (the wgmma kernel's one departure from the Pallas
    kernel's float32 P) stays inside the bf16 tolerance (2e-2)."""
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(B, Sq, Sk, Hq, Hkv, D),
                                       "bfloat16")
    got = _online_bf16_p(tq, tk, tv, causal, blk_k)
    kernel = j_flash(jq, jk, jv, causal=causal, blk_q=128, blk_k=128,
                     interpret=True)
    tol = TOL["bfloat16"]
    np.testing.assert_allclose(_f32(got), _f32(kernel), atol=tol, rtol=tol)
    np.testing.assert_allclose(
        _f32(got), _f32(attention_ref(tq, tk, tv, causal=causal)),
        atol=tol, rtol=tol)


def row_ulp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at the scale of each output row (the D values of one
    query and head): 2^(floor(log2 max |row|) - 7)."""
    top = torch.maximum(a.float().abs(), b.float().abs()).amax(-1,
                                                               keepdim=True)
    return torch.exp2(torch.floor(torch.log2(top.clamp(min=1e-30))) - 7)


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D,causal", SHAPES)
def test_bf16_p_arithmetic_independent_of_blk_k(B, Sq, Sk, Hq, Hkv, D,
                                                causal):
    """BK = 64 and 128 round P against other running maxima; the outputs
    still agree within one bf16 ulp at each row's scale."""
    _, (q, k, v) = _both(_inputs(B, Sq, Sk, Hq, Hkv, D, seed=1), "bfloat16")
    a = _online_bf16_p(q, k, v, causal, 64)
    b = _online_bf16_p(q, k, v, causal, 128)
    assert bool(((a.float() - b.float()).abs() <= row_ulp(a, b)).all())


@pytest.mark.parametrize("dtype,D,want", [
    (torch.bfloat16, 128, WGMMA_TILES), (torch.bfloat16, 64, WGMMA_TILES),
    (torch.bfloat16, 32, SIMT_TILES), (torch.bfloat16, 16, SIMT_TILES),
    (torch.float32, 128, SIMT_TILES), (torch.float32, 64, SIMT_TILES),
    (torch.float32, 16, SIMT_TILES)])
def test_tiles_follow_dtype_and_head_dim(dtype, D, want):
    """(dtype, D) alone picks the kernel: bf16 at D = 64, 128 the wgmma
    kernel (128-row q tiles), everything else the SIMT kernel."""
    assert tiles(dtype, D) is want
    assert all(bq == 128 and bk in (64, 128) for bq, bk in WGMMA_TILES)
    assert (64, 64) in SIMT_TILES


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [16, 32, 64, 128])
def test_wrapper_takes_the_tiles_of_its_kernel(dtype, D):
    _, (q, k, v) = _both(_inputs(1, 256, 256, 4, 2, D, seed=2), dtype)
    want = attention_ref(q, k, v)
    allowed = tiles(q.dtype, D)
    for blk_q, blk_k in allowed:  # each of its own tiles runs (CPU: plain)
        torch.testing.assert_close(
            flash_attention(q, k, v, blk_q=blk_q, blk_k=blk_k), want,
            rtol=0, atol=0)
    torch.testing.assert_close(flash_attention(q, k, v), want, rtol=0,
                               atol=0)
    other = WGMMA_TILES if allowed is SIMT_TILES else SIMT_TILES
    for blk_q, blk_k in other:  # the other kernel's tiles are refused
        if (blk_q, blk_k) not in allowed:
            with pytest.raises(ValueError, match="tile"):
                flash_attention(q, k, v, blk_q=blk_q, blk_k=blk_k)
    if allowed is WGMMA_TILES:  # 128-row q tiles: Sq = 64 is refused
        with pytest.raises(ValueError, match="multiples of the tiles"):
            flash_attention(q[:, :64].contiguous(), k, v)
