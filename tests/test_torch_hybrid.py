"""Port of the hybrid path (Zamba2: Mamba-2 blocks and one shared attention
block, zamba2-7b reduced) against the JAX package's: specs, the causal
conv and the Mamba-2 block in float32, ``loss_fn`` on both of the
reference's attention routes, prefill then decode with every cache, the
serving engine and its CLI, and the weights carried by
``interop.params_from_jax``.  Weights are drawn by the JAX package (a
per-path seed that is the same in every process) and carried over; inputs
are made with numpy from a seed.  On CPU tensors ``scan_op`` and the
attention take their plain versions, so nothing here launches a kernel."""
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import REGISTRY as J_REGISTRY  # noqa: E402
from repro.inference import ServeEngine as JServeEngine  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.models.param import map_specs as j_map_specs  # noqa: E402
from repro.models.param import tree_paths as j_paths  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import REGISTRY  # noqa: E402
from repro_torch.inference import ServeEngine  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.linear_scan import linear_scan  # noqa: E402
from repro_torch.launch import llmserve  # noqa: E402
from repro_torch.models import registry as R  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.models.param import (count_params, init_params,  # noqa: E402
                                      tree_paths)

ARCH = "zamba2-7b"
KEY = jax.random.PRNGKey(0)
CPU = torch.device("cpu")
# float32 throughout: the two packages sum in other orders (BLAS blocking,
# XLA fusion), a few ulps per op on values of order 1
F32_TOL = 1e-5
# bf16: activations round to 8 mantissa bits at other places in the two
# frameworks; tests/test_kernel_integration.py's bound between the
# reference's own two routes, as for the dense and ssm families
LOSS_TOL = {"float32": F32_TOL, "bfloat16": 5e-3}
JD = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TD = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _cfgs(dtype: str = "bfloat16", **kw):
    """The reduced config in both packages: 4 layers, a shared block every
    2, d_model 64, 8 SSM heads of 16, state 16, conv 2, chunk 16."""
    return (J_REGISTRY[ARCH].reduced().replace(dtype=JD[dtype], **kw),
            REGISTRY[ARCH].reduced().replace(dtype=TD[dtype], **kw))


def _j_init(tree, key) -> dict:
    """Every leaf drawn by JAX from a seed that ``zlib.crc32`` takes from
    its path (the reference's own ``hash(path)`` is salted per process):
    N(0, 1) at the reference's init scale; the leaves it initialises to
    zeros or ones (a_log, dt_bias, d_skip, conv_b, the norms) get N(0, 0.3)
    around that value, so that their paths are exercised too."""
    def leaf(path, spec):
        k = jax.random.fold_in(key, zlib.crc32("/".join(path).encode())
                               % (2 ** 31))
        x = jax.random.normal(k, spec.shape, jnp.float32)
        if spec.init in ("zeros", "ones"):
            x = float(spec.init == "ones") + 0.3 * x
        else:
            x = x * (spec.scale if spec.scale is not None else 1.0
                     if spec.init == "embed" else (
                         spec.shape[-2] if len(spec.shape) >= 2
                         else spec.shape[-1]) ** -0.5)
        return x.astype(spec.dtype)
    return j_map_specs(tree, leaf)


def _params(jcfg, dtype: str):
    pj = _j_init(JR.specs(jcfg), KEY)
    pj = jax.tree.map(lambda a: a.astype(JD[dtype]), pj)
    return pj, interop.params_from_jax(jax.tree.map(np.asarray, pj), CPU)


@pytest.fixture(scope="module")
def f32():
    """(JAX config, port config, JAX params, port params) in float32."""
    jc, tc = _cfgs("float32")
    return (jc, tc) + _params(jc, "float32")


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol=F32_TOL):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def _batch(vocab, B, S, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (B, S)).astype(np.int32),
            "labels": rng.integers(0, vocab, (B, S)).astype(np.int32)}


# ----------------------------------------------------------------------
# specs and weights
# ----------------------------------------------------------------------

@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_hybrid_specs_match_reference(reduced):
    jc, tc = J_REGISTRY[ARCH], REGISTRY[ARCH]
    if reduced:
        jc, tc = jc.reduced(), tc.reduced()
    for js_tree, ts_tree in ((JR.specs(jc), R.specs(tc)),
                             (jssm.mamba2_specs(jc, 3),
                              tssm.mamba2_specs(tc, 3))):
        js = dict(j_paths(js_tree))
        ts = dict(tree_paths(ts_tree))
        assert list(js) == list(ts)
        for p, s in ts.items():
            assert (s.shape, s.axes, s.init, s.scale) == \
                (js[p].shape, js[p].axes, js[p].init, js[p].scale), p
            assert s.dtype == torch.bfloat16 and js[p].dtype == jnp.bfloat16
    assert count_params(R.specs(tc)) == sum(
        int(np.prod(s.shape)) for _, s in j_paths(JR.specs(jc)))
    assert ttr.n_attn_apps(tc) == jtr.n_attn_apps(jc) == \
        (13 if not reduced else 2)
    assert set(R.specs(tc)["shared"]) == {"attn", "attn_norm", "mlp_norm",
                                          "mlp"}


def test_params_from_jax_carries_a_zamba2_tree_bit_for_bit():
    jc, _ = _cfgs()
    pj, pt = _params(jc, "bfloat16")
    flat_j = jax.tree_util.tree_flatten_with_path(pj)[0]
    flat_t = jax.tree.leaves(pt)
    assert len(flat_j) == len(flat_t)
    names = set()
    for (path, ja), ta in zip(flat_j, flat_t):
        names.add("/".join(p.key for p in path))
        assert ta.dtype == torch.bfloat16 and tuple(ta.shape) == ja.shape
        np.testing.assert_array_equal(
            np.asarray(ja).view(np.uint16),
            ta.view(torch.int16).numpy().view(np.uint16))
    assert {"shared/attn/wq", "shared/mlp/w_gate", "shared/attn_norm/scale",
            "blocks/a_log", "blocks/conv_w", "blocks/w_xbc",
            "blocks/norm/scale"} <= names


# ----------------------------------------------------------------------
# layers, float32
# ----------------------------------------------------------------------

def _layer(jc):
    """One layer's Mamba-2 weights (the layer axis dropped) in both
    packages."""
    pj = jax.tree.map(lambda a: a[0].astype(jnp.float32),
                      _j_init(jssm.mamba2_specs(jc, 1), KEY))
    return pj, {k: torch.from_numpy(np.array(v)) for k, v in pj.items()}


@pytest.mark.parametrize("carry", [False, True], ids=["zeros", "carry"])
def test_causal_conv_matches_reference(carry):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 11, 24)).astype(np.float32)
    w = rng.standard_normal((4, 24)).astype(np.float32)
    b = rng.standard_normal(24).astype(np.float32)
    st = rng.standard_normal((2, 3, 24)).astype(np.float32) if carry \
        else None
    jy, js = jssm._causal_conv(*(None if a is None else jnp.asarray(a)
                                 for a in (x, w, b, st)))
    ty, ts = tssm._causal_conv(*(None if a is None else torch.from_numpy(a)
                                 for a in (x, w, b, st)))
    _close(ty, jy)
    _close(ts, js, 0)


@pytest.mark.parametrize("decode", [False, True], ids=["chunked", "step"])
def test_mamba2_block_matches_reference(decode):
    """With a carried SSM state and conv state; the full sequence spans 3
    chunks of 16, a decode step is one token."""
    jc, tc = _cfgs("float32")
    pj, pt = _layer(jc)
    rng = np.random.default_rng(3)
    T = 1 if decode else 48
    di = jc.d_model * jc.ssm_expand
    x = rng.standard_normal((2, T, jc.d_model)).astype(np.float32)
    st = (rng.standard_normal((2, jc.ssm_heads, jc.ssm_state,
                               di // jc.ssm_heads)) * 0.5).astype(np.float32)
    conv = rng.standard_normal((2, jc.conv_width - 1,
                                di + 2 * jc.ssm_state)).astype(np.float32)
    jy, (js, jconv) = jssm.mamba2_block(
        pj, jnp.asarray(x), jc, state=jnp.asarray(st),
        conv_state=jnp.asarray(conv), decode=decode)
    ty, (ts, tconv) = tssm.mamba2_block(
        pt, torch.from_numpy(x), tc, state=torch.from_numpy(st),
        conv_state=torch.from_numpy(conv), decode=decode)
    assert ts.dtype == torch.float32 and ty.shape == (2, T, jc.d_model)
    _close(ty, jy)
    _close(ts, js)
    _close(tconv, jconv)  # the last rows of the x/B/C projection


# ----------------------------------------------------------------------
# model against model
# ----------------------------------------------------------------------

@pytest.mark.parametrize("route", ["plain", "pallas-interpret"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_fn_matches_reference(dtype, route, monkeypatch):
    """S=128, so that the reference's kernel route
    (``REPRO_USE_PALLAS=interpret``) takes the Pallas flash kernel in the
    shared block; 8 chunks of 16 per Mamba-2 layer."""
    if route == "pallas-interpret":
        monkeypatch.setenv("REPRO_USE_PALLAS", "interpret")
    jc, tc = _cfgs(dtype)
    pj, pt = _params(jc, dtype)
    b = _batch(jc.vocab, 2, 128)
    want = float(JR.loss_fn(pj, {k: jnp.asarray(v) for k, v in b.items()},
                            jc))
    before = (flash_attention.launches, linear_scan.launches)
    got = R.loss_fn(pt, b, tc, device="cpu")
    assert got.dtype == torch.float32 and np.isfinite(float(got))
    assert float(got) == pytest.approx(want, rel=LOSS_TOL[dtype])
    assert (flash_attention.launches, linear_scan.launches) == before


def _prefill_decode(jc, tc, pj, pt, S):
    """Prefill S tokens into a cache of S + 8, then 3 decode steps, the
    logits of each held at 1e-5; returns both final caches."""
    toks = _batch(jc.vocab, 2, S)["tokens"]
    jl_, jcache = JR.prefill(pj, {"tokens": jnp.asarray(toks)}, jc, S + 8)
    tl_, tcache = R.prefill(pt, {"tokens": toks}, tc, S + 8, device="cpu")
    _close(tl_, jl_)
    rng = np.random.default_rng(6)
    for _ in range(3):
        tok = rng.integers(0, jc.vocab, (2, 1)).astype(np.int32)
        jl_, jcache = JR.decode_step(pj, {"tokens": jnp.asarray(tok)},
                                     jcache, jc)
        tl_, tcache = R.decode_step(pt, {"tokens": tok}, tcache, tc,
                                    device="cpu")
        _close(tl_, jl_)
    return jcache, tcache


@pytest.mark.parametrize("n_layers", [4, 5], ids=["groups", "tail"])
def test_prefill_then_decode_matches_reference(n_layers):
    """4 layers: two groups of 2 Mamba-2 layers and a shared-block
    application each; 5: the same and a tail layer, so that the merged
    Mamba-2 states must come back in layer order.  S=12, inside the chunk
    of 16.  The Mamba-2 state, the conv state and the KV cache with its
    length are each held at 1e-5."""
    jc, tc = _cfgs("float32", n_layers=n_layers)
    pj, pt = _params(jc, "float32")
    jcache, tcache = _prefill_decode(jc, tc, pj, pt, 12)
    (st, conv), kv = tcache
    H, N = tc.ssm_heads, tc.ssm_state
    di = tc.d_model * tc.ssm_expand
    apps = ttr.n_attn_apps(tc)
    assert st.shape == (n_layers, 2, H, N, di // H) and \
        st.dtype == torch.float32
    assert conv.shape == (n_layers, 2, tc.conv_width - 1, di + 2 * N)
    assert kv["k"].shape == (apps, 2, 20, tc.n_kv_heads, tc.head_dim_)
    (jst, jconv), jkv = jcache
    _close(st, jst)
    _close(conv, jconv)
    for name in ("k", "v"):
        _close(kv[name], jkv[name])
    np.testing.assert_array_equal(kv["length"].numpy(),
                                  np.asarray(jkv["length"]))
    assert int(kv["length"][0]) == 15


def test_forward_matches_reference_forward(f32):
    """The full-sequence forward with the zero training cache (no KV
    cache: the shared block takes the no-cache attention), logits and the
    returned Mamba-2 and conv states, float32."""
    jc, tc, pj, pt = f32
    toks = _batch(jc.vocab, 2, 32)["tokens"]
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    jl_, ((jst, jconv), jkv) = jtr.forward(pj, jb, jc, cache=jtr.empty_cache(
        pj, jb, jc, train=True))
    tl_, ((st, conv), kv) = ttr.forward(pt, tb, tc, cache=ttr.empty_cache(
        pt, tb, tc, train=True))
    assert kv is None and jkv is None
    _close(tl_, jl_)
    _close(st, jst)
    _close(conv, jconv)


def test_prefill_matches_decode_path():
    """tests/test_archs_smoke.py::test_prefill_matches_decode_path on the
    port: decoding token t with the caches of the prefix matches the
    full-sequence forward at t (bf16, the reference's 3e-2)."""
    _, tc = _cfgs()
    params = init_params(R.specs(tc), 0, "cpu")
    S = 12
    toks = torch.from_numpy(_batch(tc.vocab, 1, S)["tokens"])
    batch = {"tokens": toks}
    full, _ = ttr.forward(params, batch, tc, cache=ttr.empty_cache(
        params, batch, tc, train=False, max_len=S + 4))
    _, cache = R.prefill(params, {"tokens": toks[:, :S - 1]}, tc, S + 4)
    step, _ = R.decode_step(params, {"tokens": toks[:, S - 1:]}, cache, tc)
    np.testing.assert_allclose(_np(full[:, -1]), _np(step[:, -1]),
                               atol=3e-2, rtol=3e-2)


def _serve(engine_cls, cfg, params, prompts, **kw):
    eng = engine_cls(cfg, params, slots=2, max_len=64, **kw)
    uids = [eng.submit(p, max_new=8) for p in prompts]
    done = eng.run(max_steps=100)
    assert sorted(r.uid for r in done) == sorted(set(uids))
    return {r.uid: list(r.generated) for r in done}


@pytest.mark.parametrize("n_layers", [4, 5], ids=["groups", "tail"])
def test_serve_engine_tokens_match_reference(n_layers):
    """3 requests of 8 tokens into 2 slots, 8 new tokens each: every
    re-prefill is at most 15 wide, inside the reduced chunk of 16 (wider
    ones that 16 does not divide trip the reference's own assert).  Greedy,
    float32: the tokens are identical."""
    jc, tc = _cfgs("float32", n_layers=n_layers)
    pj, pt = _params(jc, "float32")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, jc.vocab, 8) for _ in range(3)]
    want = _serve(JServeEngine, jc, pj, prompts)
    got = _serve(ServeEngine, tc, pt, prompts, device="cpu")
    assert got == want


def test_llmserve_cli_on_cpu(capsys):
    assert llmserve.main(["--arch", ARCH, "--requests", "2",
                          "--prompt-len", "16", "--gen", "4",
                          "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "prefill 2x16" in out and "decoded 3 steps" in out


def test_prefill_refuses_a_width_the_chunk_does_not_divide(f32):
    """The reference's ``T % c`` assert, kept (ROADMAP §3): 17 tokens over
    the reduced chunk of 16 raise in both packages, here in the first
    Mamba-2 layer."""
    jc, tc, pj, pt = f32
    toks = _batch(jc.vocab, 1, 17)["tokens"]
    with pytest.raises(AssertionError, match="not divisible"):
        JR.prefill(pj, {"tokens": jnp.asarray(toks)}, jc, 20)
    with pytest.raises(ValueError, match="T=17 not divisible by chunk=16"):
        R.prefill(pt, {"tokens": toks}, tc, 20, device="cpu")
