"""The port's linear scan against the JAX package's: the plain version
(``linear_scan`` on CPU tensors, ``linear_scan_ref``, ``scan_op``) against
the Pallas kernel in interpret mode and against ``linear_scan_ref``, on the
shapes of ``tests/test_kernels.py`` and on an odd chunk with a carried
state and a full 256-row chunk; the chunked form against the per-token
recurrence; the wrapper's checks.  Inputs are made with numpy from a seed.
The kernel itself runs only on the card (``tests/test_torch_cuda.py`` and
``chip_smoke.py``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.linear_scan import linear_scan as j_scan  # noqa: E402
from repro.kernels.linear_scan import linear_scan_ref as j_ref  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.kernels.linear_scan import (linear_scan,  # noqa: E402
                                             linear_scan_ref, scan_op)
from repro_torch.models import ssm as tssm  # noqa: E402

# tests/test_kernels.py's limits: float32 sums in another order behind the
# two-sided exp(+-P) factors (1e-3); bf16 inputs and outputs (5e-2)
TOL = {"float32": 1e-3, "bfloat16": 5e-2}
JD = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TD = {"float32": torch.float32, "bfloat16": torch.bfloat16}

SHAPES = [  # tests/test_kernels.py:57-67, (B, T, H, K, V, post, use_u, chunk)
    (1, 64, 1, 16, 16, False, True, 16),
    (2, 128, 2, 32, 32, False, True, 32),    # RWKV-6 shape
    (1, 256, 4, 64, 64, True, False, 64),    # Mamba-2 shape
    (2, 128, 2, 16, 48, True, False, 64),    # K != V
]


def _inputs(B, T, H, K, V, use_u, *, seed=0, decay=0.2, state=False):
    """float32 numpy arrays: r, k, v ~ N(0, 1); log_w = -|N(0, 1)| * decay;
    u ~ N(0, 1) or None; state0 zeros or ~ N(0, 1)."""
    rng = np.random.default_rng(seed)
    f = np.float32
    r = rng.standard_normal((B, T, H, K)).astype(f)
    k = rng.standard_normal((B, T, H, K)).astype(f)
    v = rng.standard_normal((B, T, H, V)).astype(f)
    lw = (-np.abs(rng.standard_normal((B, T, H, K))) * decay).astype(f)
    u = rng.standard_normal((H, K)).astype(f) if use_u else None
    s0 = rng.standard_normal((B, H, K, V)).astype(f) if state else \
        np.zeros((B, H, K, V), f)
    return r, k, v, lw, u, s0


def _both(arrays, dtype):
    """The same values in both packages: r, k, v in ``dtype`` (float32 ->
    bf16 rounds to nearest even in both), log_w, u and state0 float32."""
    r, k, v, lw, u, s0 = arrays
    j = [jnp.asarray(a).astype(JD[dtype]) for a in (r, k, v)] + [
        jnp.asarray(lw), None if u is None else jnp.asarray(u),
        jnp.asarray(s0)]
    t = [torch.from_numpy(a).to(TD[dtype]) for a in (r, k, v)] + [
        torch.from_numpy(lw), None if u is None else torch.from_numpy(u),
        torch.from_numpy(s0)]
    return j, t


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)


CASES = [(*s, d) for d in ("float32", "bfloat16") for s in SHAPES] + [
    # c = T = 37 (odd, not a multiple of 16) with a carried state
    (2, 37, 2, 16, 24, False, True, 64, "float32"),
    (2, 37, 2, 16, 24, True, False, 64, "bfloat16"),
    # the model's chunk: c = 256, K = V = 64, two chunks of carried state,
    # decays up to the -60/256 clamp
    (1, 512, 1, 64, 64, False, True, 256, "float32"),
]


@pytest.mark.parametrize("B,T,H,K,V,post,use_u,chunk,dtype", CASES)
def test_plain_matches_pallas_interpret_and_ref(B, T, H, K, V, post, use_u,
                                                chunk, dtype):
    arrays = _inputs(B, T, H, K, V, use_u, seed=T + K,
                     decay=0.5 if chunk == 256 else 0.2, state=T == 37)
    (jr, jk, jv, jlw, ju, js0), (r, k, v, lw, u, s0) = _both(arrays, dtype)
    o, s = linear_scan(r, k, v, lw, u, s0, chunk=chunk, post_update=post)
    assert o.dtype == TD[dtype] and s.dtype == torch.float32
    assert o.shape == (B, T, H, V) and s.shape == (B, H, K, V)
    jo, js = j_scan(jr, jk, jv, jlw, ju, js0, chunk=chunk, post_update=post,
                    interpret=True)
    ro, rs = j_ref(jr, jk, jv, jlw, u=ju, state0=js0, chunk=chunk,
                   post_update=post)
    tol = TOL[dtype]
    for want_o, want_s in ((jo, js), (ro, rs)):
        _close(o, want_o, tol)
        _close(s, want_s, tol)
    # the plain version itself, before the wrapper's cast of o
    po, ps = linear_scan_ref(r, k, v, lw, u=u, state0=s0, chunk=chunk,
                             post_update=post)
    assert po.dtype == torch.float32
    _close(po, ro, tol)
    _close(ps, rs, tol)


def _two_pass(r, k, v, lw, u, s0, chunk, post, tile=64):
    """The CUDA kernel's decomposition in float32 torch.  Each chunk of c
    rows is cut into tiles of up to 64 rows (none across chunks, so |P| <=
    60 in a tile); per tile, with P the cumulative clamped decay from the
    tile's first row, its own state dS_t = sum_i (k_i exp(P_last - P_i))
    v_i^T and decay d_t = exp(P_last) (the state pass); S_t = d_t S_{t-1}
    + dS_t from state0 (the hand-off); then o = q_eff S_{t-1} + (A masked,
    with the bonus on its diagonal) v within the tile (the output pass)."""
    B, T, H, K = r.shape
    c = min(chunk, T)
    lw = lw.clamp(float(np.float32(-60.0 / c)), 0.0)
    starts = [c0 + t0 for c0 in range(0, T, c) for t0 in range(0, c, tile)]
    S, outs = s0, []
    for t0 in starts:
        rows = slice(t0, min(t0 + tile, t0 - t0 % c + c))
        rt, kt, vt, lt = r[:, rows], k[:, rows], v[:, rows], lw[:, rows]
        P = torch.cumsum(lt, dim=1)
        Pl = P[:, -1]                                    # (B, H, K)
        dS = torch.einsum("bihk,bihv->bhkv", kt * torch.exp(Pl[:, None] - P),
                          vt)
        q = rt * torch.exp(P if post else P - lt)
        A = torch.einsum("bihk,bjhk->bhij", q, kt * torch.exp(-P))
        idx = torch.arange(A.shape[-1])
        A = A * (idx[:, None] >= idx[None, :] if post
                 else idx[:, None] > idx[None, :])
        if u is not None:
            A = A + torch.diag_embed(torch.einsum("bihk,hk,bihk->bhi", rt, u,
                                                  kt))
        outs.append(torch.einsum("bihk,bhkv->bihv", q, S)
                    + torch.einsum("bhij,bjhv->bihv", A, vt))
        S = torch.exp(Pl)[..., None] * S + dS
    return torch.cat(outs, dim=1), S


# the shapes of CASES in float32, and 32 chunks of 16 with a carried state
# and a weak decay, where the hand-off carries most of o
SPLIT_CASES = sorted({c[:8] for c in CASES}) + [
    (2, 512, 2, 32, 32, False, True, 16)]


@pytest.mark.parametrize("B,T,H,K,V,post,use_u,chunk", SPLIT_CASES)
def test_two_pass_split_matches_pallas_and_oracle(B, T, H, K, V, post, use_u,
                                                  chunk):
    """The kernel's split into a state pass, a hand-off and an output pass
    per tile of up to 64 rows is the same function as the Pallas kernel
    (interpret mode) and the JAX package's chunked_linear_attn, in float32
    at 1e-5
    of the output's scale (rtol 1e-5, atol 1e-5 max |want|): float32 sums
    behind the two-sided exp(+-P) factors differ by up to 1.4e-6 of it
    between any two summation orders here, the port's plain version
    against the Pallas kernel included."""
    weak = chunk == 16 and T == 512
    arrays = _inputs(B, T, H, K, V, use_u, seed=T + K + 1,
                     decay=0.01 if weak else 0.5 if chunk == 256 else 0.2,
                     state=weak or T == 37)
    (jr, jk, jv, jlw, ju, js0), t = _both(arrays, "float32")
    o, s = _two_pass(*t, chunk, post)
    jo, js = j_scan(jr, jk, jv, jlw, ju, js0, chunk=chunk, post_update=post,
                    interpret=True)
    ro, rs = jssm.chunked_linear_attn(jr, jk, jv, jlw, u=ju, state0=js0,
                                      chunk=chunk, post_update=post)
    for got, want in ((o, jo), (s, js), (o, ro), (s, rs)):
        np.testing.assert_allclose(
            _f32(got), _f32(want), rtol=1e-5,
            atol=1e-5 * float(np.abs(_f32(want)).max()))


@pytest.mark.parametrize("post,use_u", [(True, False), (False, True)])
def test_chunked_matches_stepwise_recurrence(post, use_u):
    """tests/test_kernels.py::test_linear_scan_matches_stepwise_recurrence
    on the port: the chunked form against the literal per-token
    recurrence, 1e-4."""
    B, T, H, K, V = 1, 32, 2, 8, 8
    r, k, v, lw, u, _ = (None if a is None else torch.from_numpy(a) for a in
                         _inputs(B, T, H, K, V, use_u, seed=5, decay=0.3))
    o, sT = linear_scan(r, k, v, lw, u, chunk=8, post_update=post)
    s = torch.zeros((B, H, K, V))
    outs = []
    for t in range(T):
        ot, s = tssm.linear_attn_step(r[:, t], k[:, t], v[:, t], lw[:, t],
                                      u=u, state=s, post_update=post)
        outs.append(ot)
    np.testing.assert_allclose(o.numpy(), torch.stack(outs, 1).numpy(),
                               atol=1e-4)
    np.testing.assert_allclose(sT.numpy(), s.numpy(), atol=1e-4)


@pytest.mark.parametrize("post", [False, True])
def test_linear_attn_step_matches_reference(post):
    rng = np.random.default_rng(6)
    B, H, K, V = 2, 3, 8, 12
    r, k, lw = (rng.standard_normal((B, H, K)).astype(np.float32)
                for _ in range(3))
    lw = -np.abs(lw)
    v = rng.standard_normal((B, H, V)).astype(np.float32)
    u = rng.standard_normal((H, K)).astype(np.float32)
    st = rng.standard_normal((B, H, K, V)).astype(np.float32)
    jo, js = jssm.linear_attn_step(*map(jnp.asarray, (r, k, v, lw)),
                                   u=jnp.asarray(u), state=jnp.asarray(st),
                                   post_update=post)
    to, ts = tssm.linear_attn_step(*map(torch.from_numpy, (r, k, v, lw)),
                                   u=torch.from_numpy(u),
                                   state=torch.from_numpy(st),
                                   post_update=post)
    _close(to, jo, 1e-5)
    _close(ts, js, 1e-5)


def test_scan_op_on_cpu_takes_the_plain_version():
    r, k, v, lw, u, s0 = (torch.from_numpy(a) for a in
                          _inputs(1, 32, 2, 16, 16, True, state=True))
    before = linear_scan.launches
    # strided inputs: the wrapper makes them contiguous
    o, s = scan_op(r.transpose(1, 2).contiguous().transpose(1, 2), k, v, lw,
                   u=u, state0=s0, chunk=16)
    want_o, want_s = linear_scan_ref(r, k, v, lw, u=u, state0=s0, chunk=16)
    torch.testing.assert_close(o, want_o, rtol=0, atol=0)
    torch.testing.assert_close(s, want_s, rtol=0, atol=0)
    assert linear_scan.launches == before


def test_wrapper_rejects_what_the_kernel_does_not_take():
    r, k, v, lw, u, s0 = (torch.from_numpy(a) for a in
                          _inputs(1, 32, 2, 16, 16, True))
    with pytest.raises(TypeError):
        linear_scan(r, k.to(torch.bfloat16), v, lw)
    with pytest.raises(TypeError):
        linear_scan(r.half(), k.half(), v.half(), lw)
    with pytest.raises(ValueError, match="divisible"):
        linear_scan(r[:, :24], k[:, :24], v[:, :24], lw[:, :24], chunk=16)
    # strided inputs are taken, as their contiguous copies
    torch.testing.assert_close(
        linear_scan(r.transpose(1, 2).contiguous().transpose(1, 2), k, v,
                    lw, chunk=16)[0],
        linear_scan(r, k, v, lw, chunk=16)[0], rtol=0, atol=0)
    with pytest.raises(ValueError, match=r"u must be"):
        linear_scan(r, k, v, lw, u[:1])
    with pytest.raises(ValueError, match="state0"):
        linear_scan(r, k, v, lw, u, s0[..., :8])
    with pytest.raises(ValueError, match="B, T, H, K"):
        linear_scan(r, k[:, :16], v, lw)
    # on CPU tensors the plain version is ordinary autograd (the card has
    # no backward kernel and refuses: tests/test_torch_cuda.py)
    rg = r.clone().requires_grad_(True)
    o, _ = linear_scan(rg, k, v, lw)
    assert o.requires_grad and torch.autograd.grad(o.sum(), rg)[0].shape \
        == r.shape
    with torch.no_grad():
        linear_scan(r.clone().requires_grad_(True), k, v, lw)
    with pytest.raises(ValueError, match="divisible"):
        tssm.chunked_linear_attn(r[:, :24], k[:, :24], v[:, :24],
                                 lw[:, :24], chunk=16)
