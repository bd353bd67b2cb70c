"""The port's linear_scan backward against the JAX package's gradient:
``linear_scan_bwd_ref`` (the plain version of the CUDA backward) against
``torch.autograd.grad`` of ``linear_scan_ref`` and of a float64 forward,
against ``jax.vjp`` of the reference's ``chunked_linear_attn`` fed the
same cotangents, and ``gradcheck``; a test-local torch copy of the CUDA
kernel's split (reverse state pass, reverse hand-off, gradient pass, per
tile of up to 64 rows inside chunks of up to 256) against the same oracles;
the clamp's zero gradient; ``linear_scan`` under grad on the CPU through
``_LinearScan``.  Inputs and cotangents are made with numpy from a seed.
The kernel itself runs only on the card (``tests/test_torch_cuda.py`` and
``chip_smoke.py``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import ssm as jssm  # noqa: E402
from repro_torch.kernels.linear_scan import (  # noqa: E402
    linear_scan, linear_scan_bwd, linear_scan_bwd_ref, linear_scan_ref)

NAMES = ("dr", "dk", "dv", "dlog_w", "du", "dstate0")

# (B, T, H, K, V, post, use_u, chunk, state0, dS_T): pre-update with the
# bonus and post-update, with and without a carried state and a final
# state's cotangent; c = T = 37 (odd); two chunks of 32; a chunk of 64 cut
# into tiles of 64 and, in the split, 40 + 24 rows by a chunk of 40
CASES = [
    (2, 64, 2, 8, 12, False, True, 16, True, True),
    (1, 64, 2, 16, 8, True, False, 32, True, False),
    (2, 37, 1, 8, 16, False, True, 64, False, True),
    (1, 64, 2, 12, 16, True, False, 64, False, False),
]


def _inputs(B, T, H, K, V, use_u, state, dst, *, seed=0, decay=0.5):
    """float32 numpy arrays: r, k, v ~ N(0, 1), log_w = -|N(0, 1)| * decay,
    u, state0 ~ N(0, 1) or None; cotangents dO ~ N(0, 1) and dS_T ~ N(0, 1)
    or None."""
    rng = np.random.default_rng(seed)
    f = np.float32

    def n(*s):
        return rng.standard_normal(s).astype(f)
    r, k, v = n(B, T, H, K), n(B, T, H, K), n(B, T, H, V)
    lw = (-np.abs(n(B, T, H, K)) * decay).astype(f)
    u = n(H, K) if use_u else None
    s0 = n(B, H, K, V) if state else None
    do = n(B, T, H, V)
    dS = n(B, H, K, V) if dst else None
    return r, k, v, lw, u, s0, do, dS


def _t(arrays, dtype=torch.float32):
    return [None if a is None else torch.from_numpy(a).to(dtype)
            for a in arrays]


def _rel(got, want) -> float:
    got, want = (np.asarray(x, np.float64) for x in (got, want))
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _given(grads, arrays):
    """(name, gradient) of the inputs that were given."""
    r, k, v, lw, u, s0 = arrays[:6]
    return [(n, g) for n, g, a in zip(NAMES, grads, (r, k, v, lw, u, s0))
            if a is not None]


def _autograd(fwd, ins, do, dS, chunk, post):
    """torch.autograd.grad of ``fwd`` (o, state) for the cotangents."""
    req = [t.clone().requires_grad_(True) for t in ins if t is not None]
    it = iter(req)
    args = [None if t is None else next(it) for t in ins]
    o, s = fwd(*args, chunk=chunk, post_update=post)
    outs, cots = [o], [do]
    if dS is not None:
        outs.append(s)
        cots.append(dS)
    return torch.autograd.grad(outs, req, cots)


def _scan_f64(r, k, v, log_w, u=None, state0=None, *, chunk, post_update):
    """chunked_linear_attn's algebra in float64, clamped at the float32
    -60/c the kernels use."""
    B, T, H, K = r.shape
    c = min(chunk, T)
    lw = log_w.clamp(float(np.float32(-60.0 / c)), 0.0)
    S = torch.zeros(B, H, K, v.shape[-1], dtype=torch.float64) \
        if state0 is None else state0
    idx = torch.arange(c)
    tri = (idx[:, None] >= idx[None, :]) if post_update else (
        idx[:, None] > idx[None, :])
    outs = []
    for n in range(T // c):
        sl = slice(n * c, (n + 1) * c)
        rb, kb, vb, lwb = r[:, sl], k[:, sl], v[:, sl], lw[:, sl]
        P = torch.cumsum(lwb, dim=1)
        q = rb * torch.exp(P if post_update else P - lwb)
        A = torch.einsum("bihk,bjhk->bhij", q, kb * torch.exp(-P)) * tri
        if u is not None:
            A = A + torch.diag_embed(torch.einsum("bchk,hk,bchk->bhc", rb, u,
                                                  kb))
        outs.append(torch.einsum("bchk,bhkv->bchv", q, S)
                    + torch.einsum("bhij,bjhv->bihv", A, vb))
        S = S * torch.exp(P[:, -1])[..., None] + torch.einsum(
            "bchk,bchv->bhkv", kb * torch.exp(P[:, -1:] - P), vb)
    return torch.cat(outs, dim=1), S


def _jax_vjp(arrays, chunk, post):
    """jax.vjp of the reference's chunked_linear_attn for the cotangents
    (a zero dS_T where none is given)."""
    r, k, v, lw, u, s0, do, dS = arrays
    B, T, H, K = r.shape
    s0j = jnp.zeros((B, H, K, v.shape[-1]), jnp.float32) if s0 is None \
        else jnp.asarray(s0)
    uj = None if u is None else jnp.asarray(u)

    def f(r, k, v, lw, uj, s0j):
        return jssm.chunked_linear_attn(r, k, v, lw, u=uj, state0=s0j,
                                        chunk=chunk, post_update=post)
    primals = tuple(map(jnp.asarray, (r, k, v, lw))) + (uj, s0j)
    _, vjp = jax.vjp(f, *primals)
    dSj = jnp.zeros_like(s0j) if dS is None else jnp.asarray(dS)
    return vjp((jnp.asarray(do), dSj))


def _split_bwd(r, k, v, lw_raw, u, s0, do, dS, chunk, post, tile=64):
    """The CUDA backward's decomposition in float32 torch.  Tiles of up to
    64 rows inside each chunk of c rows (none across chunks); the forward's
    state before each tile and each tile's decay d_t; (0) per tile
    X_t = q_t^T dO_t; (1) from G = dS_T over the tiles in reverse, G_t = G
    and G = d_t G + X_t, the last G dstate0; (2) per tile from the state
    before it and G_t, the gradient pass of csrc/linear_scan_bwd.cu: kt
    never formed (kt G as (kap d) G, dkt d = v (d G)^T), r and k for the
    bonus terms taken back from q and kap, and dlog_w as the reverse sum of
    F = dq*q - (dkap + dkt d) kap, plus the column total of (dkt d) kap,
    plus dd*d, less dq*q in pre-update, zero where the clamp binds."""
    B, T, H, K = r.shape
    V = v.shape[-1]
    c = min(chunk, T)
    lo = float(np.float32(-60.0 / c))
    lw = lw_raw.clamp(lo, 0.0)
    starts = [c0 + t0 for c0 in range(0, T, c) for t0 in range(0, c, tile)]
    spans = [slice(t0, min(t0 + tile, t0 - t0 % c + c)) for t0 in starts]
    S = torch.zeros(B, H, K, V) if s0 is None else s0
    before, decay, X = [], [], []
    for sl in spans:  # the forward's states and decays; pass 0
        P = torch.cumsum(lw[:, sl], dim=1)
        before.append(S)
        decay.append(torch.exp(P[:, -1]))
        S = decay[-1][..., None] * S + torch.einsum(
            "bihk,bihv->bhkv", k[:, sl] * torch.exp(P[:, -1:] - P), v[:, sl])
        q = r[:, sl] * torch.exp(P if post else P - lw[:, sl])
        X.append(torch.einsum("bihk,bihv->bhkv", q, do[:, sl]))
    G = torch.zeros(B, H, K, V) if dS is None else dS
    Gs = [None] * len(spans)
    for t in reversed(range(len(spans))):  # pass 1
        Gs[t] = G
        G = decay[t][..., None] * G + X[t]
    dr, dk, dlw = (torch.zeros(B, T, H, K) for _ in range(3))
    dv = torch.zeros(B, T, H, V)
    du = torch.zeros(H, K)
    for t, sl in enumerate(spans):  # pass 2
        lwb, dob, vb = lw[:, sl], do[:, sl], v[:, sl]
        n = lwb.shape[1]
        P = torch.cumsum(lwb, dim=1)
        d = decay[t]  # (B, H, K)
        ePq, emP = torch.exp(P if post else P - lwb), torch.exp(-P)
        q = r[:, sl] * ePq
        kap = k[:, sl] * emP
        idx = torch.arange(n)
        M = (idx[:, None] >= idx[None, :]) if post else (
            idx[:, None] > idx[None, :])
        A = torch.einsum("bihk,bjhk->bhij", q, kap) * M
        dA = torch.einsum("bihv,bjhv->bhij", dob, vb)
        rb, kb = q / ePq, kap / emP  # r and k again, as the kernel
        if u is not None:
            A = A + torch.diag_embed(torch.einsum("bihk,hk,bihk->bhi",
                                                  r[:, sl], u, k[:, sl]))
        dAM = dA * M
        dq = torch.einsum("bihv,bhkv->bihk", dob, before[t]) + torch.einsum(
            "bhij,bjhk->bihk", dAM, kap)
        dkap = torch.einsum("bhij,bihk->bjhk", dAM, q)
        dv[:, sl] = torch.einsum("bhij,bihv->bjhv", A, dob) + torch.einsum(
            "bjhk,bhkv->bjhv", kap * d[:, None], Gs[t])
        dktd = torch.einsum("bjhv,bhkv->bjhk", vb, Gs[t]) * d[:, None]
        ddd = (Gs[t] * before[t]).sum(-1) * d
        db = torch.diagonal(dA, dim1=-2, dim2=-1).transpose(1, 2)[..., None] \
            if u is not None else torch.zeros(B, n, H, 1)
        uu = u if u is not None else torch.zeros(H, K)
        dks = dkap + dktd
        dr[:, sl] = dq * ePq + db * uu * kb
        dk[:, sl] = dks * emP + db * uu * rb
        dPq = dq * q
        F = dPq - dks * kap
        rev = torch.flip(torch.cumsum(torch.flip(F, [1]), 1), [1])
        ztot = (dktd * kap).sum(1, keepdim=True)
        dlw[:, sl] = rev + ztot + ddd[:, None] - (0 if post else dPq)
        du += (db * rb * kb).sum((0, 1))
    dlw = dlw * ((lw_raw >= lo) & (lw_raw <= 0))
    return dr, dk, dv, dlw, du if u is not None else None, \
        G if s0 is not None else None


@pytest.mark.parametrize("case", CASES)
def test_bwd_ref_matches_autograd_of_the_plain_version(case):
    """float32: against torch.autograd.grad of linear_scan_ref (1e-5 rel
    L2: the same float32 formulas, sums in another order); float64:
    against autograd of the float64 forward (1e-12)."""
    B, T, H, K, V, post, use_u, chunk, state, dst = case
    arrays = _inputs(B, T, H, K, V, use_u, state, dst, seed=T + K)
    for dt, fwd, tol in ((torch.float32, linear_scan_ref, 1e-5),
                         (torch.float64, _scan_f64, 1e-12)):
        r, k, v, lw, u, s0, do, dS = _t(arrays, dt)
        got = linear_scan_bwd_ref(r, k, v, lw, u, s0, do, dS, chunk=chunk,
                                  post_update=post)
        want = _autograd(fwd, (r, k, v, lw, u, s0), do, dS, chunk, post)
        for (name, g), w in zip(_given(got, arrays), want):
            assert g.dtype == dt, name
            assert _rel(g.detach(), w.detach()) <= tol, (name, dt)


@pytest.mark.parametrize("case", CASES)
def test_bwd_ref_and_split_match_jax_vjp(case):
    """linear_scan_bwd_ref and the test-local copy of the kernel's split
    against jax.vjp of the reference's chunked_linear_attn, float32, rel L2
    1e-5."""
    B, T, H, K, V, post, use_u, chunk, state, dst = case
    arrays = _inputs(B, T, H, K, V, use_u, state, dst, seed=T + K)
    want = _jax_vjp(arrays, chunk, post)
    t = _t(arrays)
    got = linear_scan_bwd_ref(*t, chunk=chunk, post_update=post)
    split = _split_bwd(*t, chunk, post)
    wanted = [w for w, a in zip(want, arrays[:6]) if a is not None]
    for grads in (got, split):
        for (name, g), w in zip(_given(grads, arrays), wanted):
            assert _rel(g, np.asarray(w)) <= 1e-5, name


def test_split_at_tiles_inside_long_chunks():
    """The split with chunks of 256 cut into four tiles of 64, and a chunk
    of 100 cut into 64 + 36, each over two chunks with a carried state,
    against autograd of linear_scan_ref, float32, rel L2 1e-5."""
    for T, chunk, post in ((512, 256, False), (200, 100, True)):
        arrays = _inputs(1, T, 1, 8, 8, not post, True, True, seed=T,
                         decay=0.3)
        r, k, v, lw, u, s0, do, dS = t = _t(arrays)
        want = _autograd(linear_scan_ref, (r, k, v, lw, u, s0), do, dS,
                         chunk, post)
        for (name, g), w in zip(_given(_split_bwd(*t, chunk, post), arrays),
                                want):
            assert _rel(g, w) <= 1e-5, (T, name)


class _F64Scan(torch.autograd.Function):
    """The float64 forward with linear_scan_bwd_ref as its backward: what
    gradcheck holds against finite differences."""

    @staticmethod
    def forward(ctx, r, k, v, lw, u, s0, chunk, post):
        ctx.save_for_backward(r, k, v, lw, u, s0)
        ctx.chunk, ctx.post = chunk, post
        return _scan_f64(r, k, v, lw, u, s0, chunk=chunk, post_update=post)

    @staticmethod
    def backward(ctx, do, dS):
        return (*linear_scan_bwd_ref(*ctx.saved_tensors, do, dS,
                                     chunk=ctx.chunk,
                                     post_update=ctx.post), None, None)


@pytest.mark.parametrize("post", [False, True])
def test_gradcheck_float64(post):
    arrays = _inputs(1, 12, 1, 3, 4, not post, True, True, seed=2)
    ins = [t.requires_grad_(True) if t is not None else None
           for t in _t(arrays[:6], torch.float64)]
    assert torch.autograd.gradcheck(
        lambda *a: _F64Scan.apply(*a, 4, post), tuple(ins), eps=1e-6,
        atol=1e-7, rtol=1e-6)


def test_log_w_gradient_is_zero_where_the_clamp_binds():
    """log_w below -60/c (and above 0) has a zero gradient, as jnp.clip's
    and torch.clamp's; elsewhere it is not."""
    arrays = list(_inputs(1, 32, 2, 8, 8, True, True, True, seed=9))
    lw = arrays[3]
    below = np.zeros(lw.shape, bool)
    below[:, ::3] = True
    lw[below] = -60.0 / 16 * 2.0
    lw[:, 1, 0, 0] = 0.25
    grads = linear_scan_bwd_ref(*_t(arrays), chunk=16)
    dlw = grads[3].numpy()
    assert np.all(dlw[below] == 0.0) and dlw[0, 1, 0, 0] == 0.0
    assert np.count_nonzero(dlw[~below]) >= dlw[~below].size - 1


def test_linear_scan_under_grad_takes_the_autograd_function():
    """On CPU tensors that require grad, linear_scan goes through
    _LinearScan (the plain forward, then linear_scan_bwd_ref) and gives
    autograd's gradient of linear_scan_ref; its backward is not
    differentiable again; linear_scan_bwd checks its cotangents."""
    arrays = _inputs(1, 32, 2, 8, 8, True, True, True, seed=3)
    r, k, v, lw, u, s0, do, dS = _t(arrays)
    ins = [t.clone().requires_grad_(True) for t in (r, k, v, lw, u, s0)]
    o, s = linear_scan(*ins, chunk=16)
    assert type(o.grad_fn).__name__ == "_LinearScanBackward"
    got = torch.autograd.grad((o, s), ins, (do, dS))
    want = _autograd(linear_scan_ref, (r, k, v, lw, u, s0), do, dS, 16,
                     False)
    for name, g, w in zip(NAMES, got, want):
        assert _rel(g, w) <= 1e-6, name
    o, _ = linear_scan(*ins, chunk=16)
    dr, = torch.autograd.grad((o * o).sum(), ins[0], create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable"):
        dr.sum().backward()
    with pytest.raises(ValueError, match="do must be"):
        linear_scan_bwd(r, k, v, lw, u, s0, do[..., :4], chunk=16)
    with pytest.raises(ValueError, match="dstate must be"):
        linear_scan_bwd(r, k, v, lw, u, s0, do, dS[..., :4], chunk=16)
