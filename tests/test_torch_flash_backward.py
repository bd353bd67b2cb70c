"""The flash attention backward on the CPU: ``attention_bwd_ref`` (the
plain version of the hand-written backward kernel, whose CUDA source runs
only on the card, ``tests/test_torch_cuda.py``) against autograd of the
port's ``attention_ref`` and against the JAX package's gradient of its
``attention_ref`` (``jax.vjp``: what XLA takes through the forward, the
JAX package having no backward kernel); ``flash_attention`` under grad on
CPU tensors; ``torch.autograd.gradcheck`` of the formulas in float64; the
backward's input checks and its refusal of double backward; head dims 96
and 112 against the JAX package's gradient.  Inputs are made with numpy
from a seed."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import attention_ref as j_ref  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    attention_bwd_ref, attention_delta_ref, attention_ref, flash_attention,
    flash_attention_bwd, flash_attention_with_lse)
from repro_torch.kernels.flash_attention.flash_attention import (  # noqa: E402
    HEAD_DIMS, bwd_tile)

# (B, Sq, Sk, Hq, Hkv, D, causal): GQA 4:1 at D = 16 and 64, MHA, causal
# and not; Sk != Sq only bidirectional (the causal mask is top-left
# aligned, for Sq == Sk)
CASES = [s + (c,) for s in ((2, 64, 64, 4, 1, 16), (1, 128, 128, 8, 2, 64),
                            (1, 64, 64, 2, 2, 32)) for c in (True, False)
         ] + [(1, 64, 128, 4, 1, 16, False)]
# float32: the formulas and autograd sum in other orders, a few ulps of
# values of order 1 (1e-6); the JAX package's XLA sums differ more (1e-5)
TOL = 1e-6
JAX_TOL = 1e-5


def _inputs(B, Sq, Sk, Hq, Hkv, D, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Sq, Hq, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D),
                      (B, Sq, Hq, D))]


def _autograd(q, k, v, do, causal):
    q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    o = attention_ref(q, k, v, causal=causal)
    return o.detach(), torch.autograd.grad(o, (q, k, v), torch.from_numpy(do))


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D,causal", CASES)
def test_bwd_ref_matches_autograd_of_attention_ref(B, Sq, Sk, Hq, Hkv, D,
                                                   causal):
    q, k, v, do = _inputs(B, Sq, Sk, Hq, Hkv, D)
    o, want = _autograd(q, k, v, do, causal)
    got = attention_bwd_ref(*(torch.from_numpy(a) for a in (q, k, v)), o,
                            torch.from_numpy(do), causal=causal)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_bwd_ref_matches_jax_gradient(causal):
    q, k, v, do = _inputs(2, 64, 64, 4, 1, 16, seed=1)
    o, vjp = jax.vjp(lambda a, b, c: j_ref(a, b, c, causal=causal),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    got = attention_bwd_ref(*(torch.from_numpy(a) for a in (q, k, v)),
                            torch.from_numpy(np.array(o)),
                            torch.from_numpy(do), causal=causal)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=JAX_TOL,
                                   rtol=JAX_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_under_grad_on_cpu(causal):
    q, k, v, do = _inputs(1, 128, 128, 8, 2, 64, seed=2)
    _, want = _autograd(q, k, v, do, causal)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    before = flash_attention.bwd_launches
    o = flash_attention(tq, tk, tv, causal=causal)
    assert o.requires_grad
    got = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(do))
    assert flash_attention.bwd_launches == before  # CPU: the plain version
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=TOL, rtol=TOL)
    # without grad, or on inputs that need none, no graph is built
    with torch.no_grad():
        assert not flash_attention(tq, tk, tv, causal=causal).requires_grad
    assert not flash_attention(*(t.detach() for t in (tq, tk, tv)),
                               causal=causal).requires_grad


class _Dense(torch.autograd.Function):
    """``attention_ref`` with ``attention_bwd_ref`` as its backward: what
    ``_FlashAttention`` runs on CPU tensors, in any float dtype."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        o = attention_ref(q, k, v, causal=causal)
        ctx.save_for_backward(q, k, v, o)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        return (*attention_bwd_ref(*ctx.saved_tensors, do,
                                   causal=ctx.causal), None)


@pytest.mark.parametrize("causal", [True, False])
def test_bwd_formulas_pass_gradcheck_in_float64(causal):
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal(s)).requires_grad_(True)
               for s in ((1, 8, 4, 4), (1, 8, 2, 4), (1, 8, 2, 4)))
    assert q.dtype == torch.float64
    assert torch.autograd.gradcheck(
        lambda a, b, c: _Dense.apply(a, b, c, causal), (q, k, v))


def test_double_backward_raises():
    q, k, v, _ = _inputs(1, 64, 64, 2, 1, 16, seed=4)
    tq = torch.from_numpy(q).requires_grad_(True)
    o = flash_attention(tq, torch.from_numpy(k), torch.from_numpy(v))
    dq, = torch.autograd.grad((o * o).sum(), tq, create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable"):
        dq.sum().backward()


def test_bwd_checks_its_inputs():
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(1, 64, 64, 2, 1, 16))
    o = attention_ref(q, k, v)
    with pytest.raises(ValueError, match="multiples of 64"):
        flash_attention_bwd(q[:, :32], k, v, o[:, :32], do[:, :32])
    with pytest.raises(TypeError, match="float32 or all bfloat16"):
        flash_attention_bwd(q, k, v, o, do.to(torch.bfloat16))
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_bwd(q[..., :8], k[..., :8], v[..., :8], o[..., :8],
                            do[..., :8])
    with pytest.raises(ValueError, match="must be"):
        flash_attention_bwd(q, k, v, o[:, :, :1], do)
    dq, dk, dv = flash_attention_bwd(*(t.to(torch.bfloat16)
                                       for t in (q, k, v, o, do)))
    assert (dq.dtype, dk.dtype, dv.dtype) == (torch.bfloat16,) * 3


# ----------------------------------------------------------------------
# lse from the forward, delta
# ----------------------------------------------------------------------

def _j_lse(q, k, causal):
    """The row log-sum-exp of the JAX package's scores: scale q.k^T with
    K repeated to the query heads, masked with -1e30 as its
    ``attention_ref``, by ``jax.nn.logsumexp`` -> (B, Hq, Sq)."""
    Sq, Hq, D = q.shape[1:]
    Sk, Hkv = k.shape[1:3]
    kj = jnp.repeat(jnp.asarray(k), Hq // Hkv, axis=2)
    s = jnp.einsum("bqhd,bkhd->bhqk", jnp.asarray(q), kj) * D ** -0.5
    if causal:
        s = jnp.where(jnp.arange(Sk)[None, :] <= jnp.arange(Sq)[:, None], s,
                      -1e30)
    return np.asarray(jax.nn.logsumexp(s, axis=-1))


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D,causal", CASES)
def test_plain_lse_matches_jax_logsumexp(B, Sq, Sk, Hq, Hkv, D, causal):
    q, k, v, _ = _inputs(B, Sq, Sk, Hq, Hkv, D, seed=5)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    o, lse = attention_ref(tq, tk, tv, causal=causal, return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (B, Hq, Sq)
    assert torch.equal(o, attention_ref(tq, tk, tv, causal=causal))
    np.testing.assert_allclose(lse.numpy(), _j_lse(q, k, causal),
                               atol=TOL, rtol=TOL)
    # the forward's CPU route returns the same pair
    fo, flse = flash_attention_with_lse(tq, tk, tv, causal=causal)
    assert torch.equal(fo, o) and torch.equal(flse, lse)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_bwd_ref_given_lse_equals_bwd_ref_without(dtype, causal):
    q, k, v, do = (torch.from_numpy(a).to(dtype)
                   for a in _inputs(1, 128, 128, 8, 2, 64, seed=6))
    o, lse = attention_ref(q, k, v, causal=causal, return_lse=True)
    got = attention_bwd_ref(q, k, v, o, do, causal=causal, lse=lse)
    want = attention_bwd_ref(q, k, v, o, do, causal=causal)
    for g, w in zip(got, want):
        assert g.dtype == dtype and torch.equal(g, w)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_saves_lse_on_cpu(causal):
    """The CPU route of ``_FlashAttention`` saves q, k, v, o and the plain
    lse, and its gradients are those of the formulas without a given lse
    (and of autograd, ``test_flash_attention_under_grad_on_cpu``)."""
    q, k, v, do = _inputs(1, 128, 128, 8, 2, 64, seed=7)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    o = flash_attention(tq, tk, tv, causal=causal)
    saved = o.grad_fn.saved_tensors
    _, lse = attention_ref(*(t.detach() for t in (tq, tk, tv)),
                           causal=causal, return_lse=True)
    assert len(saved) == 5 and torch.equal(saved[3], o.detach())
    assert torch.equal(saved[4], lse)
    got = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(do))
    want = attention_bwd_ref(*(torch.from_numpy(a) for a in (q, k, v)),
                             o.detach(), torch.from_numpy(do), causal=causal)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_delta(dtype):
    """delta = rowsum(do * o), (B, Hq, Sq), against float64 numpy on the
    same (rounded) values."""
    _, _, _, do = _inputs(2, 64, 64, 4, 1, 32, seed=8)
    o = np.random.default_rng(9).standard_normal(do.shape).astype(np.float32)
    to, tdo = torch.from_numpy(o).to(dtype), torch.from_numpy(do).to(dtype)
    got = attention_delta_ref(to, tdo)
    want = np.einsum("bqhd,bqhd->bhq", to.double().numpy(),
                     tdo.double().numpy())
    assert got.dtype == torch.float32 and got.shape == (2, 4, 64)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


def test_bwd_checks_its_lse():
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(1, 64, 64, 2, 1, 16))
    o, lse = attention_ref(q, k, v, return_lse=True)
    with pytest.raises(ValueError, match="lse must be"):
        flash_attention_bwd(q, k, v, o, do, lse=lse[:, :, :32])
    with pytest.raises(ValueError, match="lse must be"):
        flash_attention_bwd(q, k, v, o, do, lse=lse.double())
    got = flash_attention_bwd(q, k, v, o, do, lse=lse)
    for g, w in zip(got, attention_bwd_ref(q, k, v, o, do)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_at_head_dim_96_matches_jax_gradient(causal):
    """phi-3-vision-4.2b's head dim (96): ``flash_attention`` under grad on
    CPU tensors (``_FlashAttention``, then ``flash_attention_bwd``) and
    ``flash_attention_bwd`` itself against ``jax.vjp`` of the JAX
    package's attention_ref, GQA 2:1."""
    q, k, v, do = _inputs(1, 128, 128, 4, 2, 96, seed=7)
    o, vjp = jax.vjp(lambda a, b, c: j_ref(a, b, c, causal=causal),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = flash_attention(tq, tk, tv, causal=causal)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    direct = flash_attention_bwd(tq.detach(), tk.detach(), tv.detach(),
                                 out.detach(), torch.from_numpy(do),
                                 causal=causal)
    for grads in (got, direct):
        for g, w in zip(grads, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       atol=JAX_TOL, rtol=JAX_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_at_head_dim_112_matches_jax_gradient(causal):
    """zamba2-7b's shared block (3584 / 32 = 112), GQA 3:1: o from the JAX
    package's Pallas kernel in interpret mode, then ``flash_attention``
    under grad on CPU tensors and ``flash_attention_bwd`` on that o against
    ``jax.vjp`` of the JAX package's attention_ref (JAX cannot
    differentiate its ``pallas_call``; off the TPU the reference's
    attention and its gradient are attention_ref's)."""
    from repro.kernels.flash_attention import flash_attention as j_flash
    q, k, v, do = _inputs(1, 128, 128, 6, 2, 112, seed=10)
    o_pallas = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       causal=causal, interpret=True)
    o, vjp = jax.vjp(lambda a, b, c: j_ref(a, b, c, causal=causal),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    np.testing.assert_allclose(np.asarray(o_pallas), np.asarray(o),
                               atol=JAX_TOL, rtol=JAX_TOL)
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = flash_attention(tq, tk, tv, causal=causal)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    direct = flash_attention_bwd(tq.detach(), tk.detach(), tv.detach(),
                                 torch.from_numpy(np.array(o_pallas)),
                                 torch.from_numpy(do), causal=causal)
    for grads in (got, direct):
        for g, w in zip(grads, want):
            assert g.shape == w.shape
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       atol=JAX_TOL, rtol=JAX_TOL)


def test_bwd_at_head_dim_112_in_bf16_matches_float32_formulas():
    """bf16 at D = 112 (the dtype zamba2-7b trains in) takes the same
    formulas: its gradients within the card's bf16 tolerance (2e-2 rel
    L2) of the float32 gradients of the same rounded values."""
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16)
                   for a in _inputs(1, 128, 128, 4, 4, 112, seed=11))
    o, lse = attention_ref(q, k, v, return_lse=True)
    got = flash_attention_bwd(q, k, v, o, do, lse=lse)
    f = [t.float() for t in (q, k, v, do)]
    want = attention_bwd_ref(f[0], f[1], f[2], attention_ref(*f[:3]), f[3])
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        assert float((g.float() - w).norm() / w.norm()) <= 2e-2


# ----------------------------------------------------------------------
# routing: bf16 at D = 64, 112, 128 takes the wgmma backward
# ----------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("D", HEAD_DIMS)
def test_bwd_tile_by_dtype_and_head_dim(D, dtype):
    """(dtype, D) alone picks the backward's tile: bf16 at D = 64, 112
    (zamba2-7b's shared block) and 128 the wgmma kernel's 64 q rows by 128
    keys, every other pair the SIMT kernel's 64 by 64 (bf16 at D = 96
    included)."""
    wgmma = dtype == torch.bfloat16 and D in (64, 112, 128)
    assert bwd_tile(dtype, D) == ((64, 128) if wgmma else (64, 64))


def test_bwd_at_head_dim_112_takes_the_wgmma_lengths_on_cpu_too():
    """The length check runs on CPU tensors as on the card: bf16 at
    D = 112 refuses Sk = 192 (not a multiple of the wgmma kernel's 128
    keys), float32 at D = 112 takes it (the SIMT kernel's 64) and gives
    the plain version's gradients."""
    q, k, v, do = (torch.from_numpy(a)
                   for a in _inputs(1, 192, 192, 4, 2, 112, seed=12))
    o, lse = attention_ref(q, k, v, return_lse=True)
    bf = [t.to(torch.bfloat16) for t in (q, k, v, o, do)]
    with pytest.raises(ValueError, match="multiples of 64 and 128"):
        flash_attention_bwd(*bf, lse=lse)
    got = flash_attention_bwd(q, k, v, o, do, lse=lse)
    for g, w in zip(got, attention_bwd_ref(q, k, v, o, do)):
        assert g.dtype == torch.float32 and torch.equal(g, w)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "bidir"])
def test_bwd_at_head_dim_112_in_bf16_with_gqa_matches_float32_formulas(
        causal):
    """bf16 at D = 112, GQA 6 over 2, S = 256 (two of the wgmma kernel's
    128-key tiles): the gradients within 2e-2 rel L2 of the float32
    gradients of the same rounded values, as the 4/4 case above."""
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16)
                   for a in _inputs(1, 256, 256, 6, 2, 112, seed=13))
    o, lse = attention_ref(q, k, v, causal=causal, return_lse=True)
    got = flash_attention_bwd(q, k, v, o, do, lse=lse, causal=causal)
    f = [t.float() for t in (q, k, v, do)]
    want = attention_bwd_ref(f[0], f[1], f[2],
                             attention_ref(*f[:3], causal=causal), f[3],
                             causal=causal)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        assert float((g.float() - w).norm() / w.norm()) <= 2e-2
