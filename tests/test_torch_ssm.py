"""Port of the RWKV-6 path (``ssm`` family, rwkv6-1.6b) against the JAX
package's: specs, the time-mix and channel-mix layers in float32,
``loss_fn``, prefill then decode, the serving engine and its CLI, and the
weights carried by ``interop.params_from_jax``.  Weights are drawn by the
JAX package (or with numpy) and carried over; inputs are made with numpy
from a seed.  On CPU tensors ``scan_op`` takes the plain chunked version,
so nothing here launches the kernel."""
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
from repro.models.param import init_params as j_init  # noqa: E402
from repro.models.param import tree_paths as j_paths  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import REGISTRY  # noqa: E402
from repro_torch.inference import ServeEngine  # noqa: E402
from repro_torch.kernels.linear_scan import linear_scan  # noqa: E402
from repro_torch.launch import llmserve  # noqa: E402
from repro_torch.models import registry as R  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.models.param import (count_params, init_params,  # noqa: E402
                                      tree_paths)

ARCH = "rwkv6-1.6b"
KEY = jax.random.PRNGKey(0)
CPU = torch.device("cpu")
# float32 throughout: the two packages sum in other orders (BLAS blocking,
# XLA fusion), a few ulps per op on values of order 1
F32_TOL = 1e-5
# bf16: activations round to 8 mantissa bits at other places in the two
# frameworks; tests/test_kernel_integration.py's bound between the
# reference's own two routes, as for the dense family
LOSS_TOL = {"float32": F32_TOL, "bfloat16": 5e-3}
JD = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TD = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _cfgs(dtype: str = "bfloat16"):
    """The reduced config in both packages: 2 layers, d_model 64, 4 heads
    of 16, chunk 16."""
    return (J_REGISTRY[ARCH].reduced().replace(dtype=JD[dtype]),
            REGISTRY[ARCH].reduced().replace(dtype=TD[dtype]))


def _random_tree(specs, seed: int):
    """Every leaf drawn with numpy at the reference's init scale (the
    spec's ``scale``, else fan-in), float32; the leaves the reference
    initialises to zeros or ones (mix, u, w_base, norms) get N(0, 0.3)
    around that value, so that their paths are exercised too."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, s in specs.items():
        if isinstance(s, dict):
            out[k] = _random_tree(s, int(rng.integers(1 << 30)))
            continue
        if s.init in ("zeros", "ones"):
            base, std = float(s.init == "ones"), 0.3
        else:
            base = 0.0
            std = s.scale if s.scale is not None else (
                s.shape[-2] if len(s.shape) >= 2 else s.shape[-1]) ** -0.5
        out[k] = (base + rng.standard_normal(s.shape) * std).astype(
            np.float32)
    return out


def _params(jcfg, dtype: str = "bfloat16", random: bool = False):
    if random:
        pn = _random_tree(JR.specs(jcfg), 1)
        pj = jax.tree.map(lambda a: jnp.asarray(a).astype(JD[dtype]), pn)
    else:
        pj = j_init(JR.specs(jcfg), KEY)
        if dtype == "float32":
            pj = jax.tree.map(lambda a: a.astype(jnp.float32), pj)
    return pj, interop.params_from_jax(jax.tree.map(np.asarray, pj), CPU)


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
def test_ssm_specs_match_reference(reduced):
    jc, tc = J_REGISTRY[ARCH], REGISTRY[ARCH]
    if reduced:
        jc, tc = jc.reduced(), tc.reduced()
    for js_tree, ts_tree in ((JR.specs(jc), R.specs(tc)),
                             (jssm.rwkv6_specs(jc, 3),
                              tssm.rwkv6_specs(tc, 3))):
        js = dict(j_paths(js_tree))
        ts = dict(tree_paths(ts_tree))
        assert js.keys() == ts.keys()
        for p, s in ts.items():
            assert (s.shape, s.axes, s.init, s.scale) == \
                (js[p].shape, js[p].axes, js[p].init, js[p].scale), p
            assert s.dtype == torch.bfloat16 and js[p].dtype == jnp.bfloat16
    assert count_params(R.specs(tc)) == sum(
        int(np.prod(s.shape)) for _, s in j_paths(JR.specs(jc)))
    assert {"tm_norm", "cm_norm", "mix", "u", "w_lora_a"} <= set(
        R.specs(tc)["blocks"])


def test_params_from_jax_carries_an_rwkv6_tree_bit_for_bit():
    jc, _ = _cfgs()
    pj, pt = _params(jc, random=True)
    flat_j = jax.tree_util.tree_flatten_with_path(pj)[0]
    flat_t = jax.tree.leaves(pt)
    assert len(flat_j) == len(flat_t)
    names = set()
    for (path, ja), ta in zip(flat_j, flat_t):
        names.add(path[-1].key)
        assert ta.dtype == torch.bfloat16 and tuple(ta.shape) == ja.shape
        np.testing.assert_array_equal(
            np.asarray(ja).view(np.uint16),
            ta.view(torch.int16).numpy().view(np.uint16))
    assert {"mix", "u", "w_lora_a", "w_lora_b", "ln_x_scale", "cm_mix",
            "cm_k", "cm_v", "cm_r"} <= names


# ----------------------------------------------------------------------
# layers, float32
# ----------------------------------------------------------------------

def _layer_inputs(cfg, T, seed):
    rng = np.random.default_rng(seed)
    H, K = cfg.n_heads, cfg.d_model // cfg.n_heads
    x = rng.standard_normal((2, T, cfg.d_model)).astype(np.float32)
    prev = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    st = (rng.standard_normal((2, H, K, K)) * 0.5).astype(np.float32)
    return x, prev, st


def _layer_params(jcfg):
    pn = _random_tree(jssm.rwkv6_specs(jcfg, 1), 2)
    pn = {k: v[0] for k, v in pn.items()}
    pn["w_base"] = pn["w_base"] - 1.0   # decays near e^-e^-1, as trained
    return ({k: jnp.asarray(v) for k, v in pn.items()},
            {k: torch.from_numpy(v) for k, v in pn.items()})


@pytest.mark.parametrize("decode", [False, True], ids=["chunked", "step"])
def test_rwkv6_time_mix_matches_reference(decode):
    """With a carried state and carry; the full sequence spans 3 chunks of
    16, a decode step is one token."""
    jc, tc = _cfgs("float32")
    pj, pt = _layer_params(jc)
    x, prev, st = _layer_inputs(jc, 1 if decode else 48, 3)
    jy, (js, jcar) = jssm.rwkv6_time_mix(
        pj, jnp.asarray(x), jnp.asarray(prev), jc, state=jnp.asarray(st),
        decode=decode)
    ty, (ts, tcar) = tssm.rwkv6_time_mix(
        pt, torch.from_numpy(x), torch.from_numpy(prev), tc,
        state=torch.from_numpy(st), decode=decode)
    assert ts.dtype == torch.float32 and ty.dtype == torch.float32
    _close(ty, jy)
    _close(ts, js)
    _close(tcar, jcar, 0)


@pytest.mark.parametrize("decode", [False, True], ids=["chunked", "step"])
def test_rwkv6_channel_mix_matches_reference(decode):
    jc, tc = _cfgs("float32")
    pj, pt = _layer_params(jc)
    x, prev, _ = _layer_inputs(jc, 1 if decode else 48, 4)
    jy, jcar = jssm.rwkv6_channel_mix(pj, jnp.asarray(x), jnp.asarray(prev),
                                      jc, decode=decode)
    ty, tcar = tssm.rwkv6_channel_mix(pt, torch.from_numpy(x),
                                      torch.from_numpy(prev), tc,
                                      decode=decode)
    _close(ty, jy)
    _close(tcar, jcar, 0)


# ----------------------------------------------------------------------
# model against model
# ----------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_fn_matches_reference(dtype):
    """S=64: four chunks of 16 per layer, with the carried state."""
    jc, tc = _cfgs(dtype)
    pj, pt = _params(jc, dtype, random=True)
    b = _batch(jc.vocab, 2, 64)
    want = float(JR.loss_fn(pj, {k: jnp.asarray(v) for k, v in b.items()},
                            jc))
    got = R.loss_fn(pt, b, tc, device="cpu")
    assert got.dtype == torch.float32 and np.isfinite(float(got))
    assert float(got) == pytest.approx(want, rel=LOSS_TOL[dtype])


@pytest.mark.parametrize("chunk,S", [(16, 12), (256, 127)])
def test_prefill_then_decode_matches_reference(chunk, S):
    """(16, 12): the reduced chunk.  (256, 127): the full config's chunk,
    where the prefill clamps log_w at -60/127 and the decode steps do not
    (a reference quirk, ROADMAP queue 3): the port gives the reference's
    values either way."""
    jc, tc = (c.replace(chunk_size=chunk) for c in _cfgs("float32"))
    pj, pt = _params(jc, "float32", random=True)
    toks = _batch(jc.vocab, 2, S)["tokens"]
    jl_, jcache = JR.prefill(pj, {"tokens": jnp.asarray(toks)}, jc, S + 8)
    tl_, tcache = R.prefill(pt, {"tokens": toks}, tc, S + 8, device="cpu")
    (st, tm, cm), counter = tcache
    H, K = tc.n_heads, tc.d_model // tc.n_heads
    assert st.shape == (tc.n_layers, 2, H, K, K) and st.dtype == \
        torch.float32
    assert tm.shape == cm.shape == (tc.n_layers, 2, 1, tc.d_model)
    assert counter.dtype == torch.int32 and counter.dim() == 0
    _close(tl_, jl_)
    rng = np.random.default_rng(6)
    for _ in range(3):
        tok = rng.integers(0, jc.vocab, (2, 1)).astype(np.int32)
        jl_, jcache = JR.decode_step(pj, {"tokens": jnp.asarray(tok)},
                                     jcache, jc)
        tl_, tcache = R.decode_step(pt, {"tokens": tok}, tcache, tc,
                                    device="cpu")
        _close(tl_, jl_)
    for t, j in zip(tcache[0], jcache[0]):
        _close(t, j)
    assert int(tcache[1]) == int(jcache[1]) == S + 3


def test_prefill_matches_decode_path():
    """tests/test_archs_smoke.py::test_prefill_matches_decode_path on the
    port: decoding token t with the state of the prefix matches the
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


def test_forward_matches_reference_forward():
    """The full-sequence forward with the zero state, logits and the
    returned state, float32 (jtr.forward is what loss_fn and prefill
    run)."""
    jc, tc = _cfgs("float32")
    pj, pt = _params(jc, "float32", random=True)
    toks = _batch(jc.vocab, 2, 32)["tokens"]
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    jl_, jcache = jtr.forward(pj, jb, jc, cache=jtr.empty_cache(
        pj, jb, jc, train=True))
    tl_, tcache = ttr.forward(pt, tb, tc, cache=ttr.empty_cache(
        pt, tb, tc, train=True))
    _close(tl_, jl_)
    for t, j in zip(tcache[0], jcache[0]):
        _close(t, j)


def _serve(engine_cls, cfg, params, prompts, **kw):
    eng = engine_cls(cfg, params, slots=2, max_len=64, **kw)
    uids = [eng.submit(p, max_new=8) for p in prompts]
    done = eng.run(max_steps=100)
    assert sorted(r.uid for r in done) == sorted(set(uids))
    return {r.uid: list(r.generated) for r in done}


def test_serve_engine_tokens_match_reference():
    """3 requests of 8 tokens into 2 slots, 8 new tokens each: every
    re-prefill is at most 15 wide, inside the reduced chunk of 16 (wider
    ones that 16 does not divide trip the reference's own assert).  Greedy,
    float32: the tokens are identical."""
    jc, tc = _cfgs("float32")
    pj, pt = _params(jc, "float32", random=True)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, jc.vocab, 8) for _ in range(3)]
    want = _serve(JServeEngine, jc, pj, prompts)
    before = linear_scan.launches
    got = _serve(ServeEngine, tc, pt, prompts, device="cpu")
    assert got == want
    assert linear_scan.launches == before


def test_llmserve_cli_on_cpu(capsys):
    assert llmserve.main(["--arch", ARCH, "--requests", "2",
                          "--prompt-len", "8", "--gen", "4",
                          "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "prefill 2x8" in out and "decoded 3 steps" in out


def test_prefill_refuses_a_width_the_chunk_does_not_divide():
    """A reference quirk the port keeps (ROADMAP queue 3): 17 tokens over
    the reduced chunk of 16 trip the reference's ``T % c`` assert; the
    port raises at the same place."""
    jc, tc = _cfgs("float32")
    pj, pt = _params(jc, "float32")
    toks = _batch(jc.vocab, 1, 17)["tokens"]
    with pytest.raises(AssertionError, match="not divisible"):
        JR.prefill(pj, {"tokens": jnp.asarray(toks)}, jc, 20)
    with pytest.raises(ValueError, match="T=17 not divisible by chunk=16"):
        R.prefill(pt, {"tokens": toks}, tc, 20, device="cpu")
