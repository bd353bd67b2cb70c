"""Port of the dense LLM path against the JAX package's: configs, specs and
initialisation; each layer in float32; ``loss_fn`` on both of the
reference's attention routes; prefill and decode; the serving engine and
its CLI.  Weights are drawn by the JAX package (with a per-path seed that
is the same in every process, ``_j_init``) and carried over with
``interop.params_from_jax``; inputs are made with numpy from a seed."""
import dataclasses
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import REGISTRY as J_REGISTRY  # noqa: E402
from repro.inference import ServeEngine as JServeEngine  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro.models.param import init_params as j_init  # noqa: E402
from repro.models.param import map_specs as j_map_specs  # noqa: E402
from repro.models.param import tree_paths as j_paths  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import REGISTRY  # noqa: E402
from repro_torch.inference import ServeEngine  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.launch import llmserve  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import registry as R  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.models.param import (count_params, init_params,  # noqa: E402
                                      tree_paths)

ARCHS = sorted(J_REGISTRY)
DENSE = sorted(a for a in ARCHS if J_REGISTRY[a].family == "dense")
KEY = jax.random.PRNGKey(0)
CPU = torch.device("cpu")
# float32 throughout: the two packages sum in other orders (BLAS blocking,
# XLA fusion), a few ulps per op on values of order 1
F32_TOL = 1e-5


def _cfgs(arch: str, dtype: str = "bfloat16", **kw):
    """The reduced config in both packages; llama3-8b keeps GQA (its
    ``reduced()`` has n_kv_heads == n_heads == 4)."""
    if arch == "llama3-8b":
        kw.setdefault("n_kv_heads", 2)
    jd = {"bfloat16": jnp.bfloat16, "float32": jnp.float32}[dtype]
    td = {"bfloat16": torch.bfloat16, "float32": torch.float32}[dtype]
    return (J_REGISTRY[arch].reduced().replace(dtype=jd, **kw),
            REGISTRY[arch].reduced().replace(dtype=td, **kw))


def _j_init(tree, key) -> dict:
    """The JAX package's ``init_params`` with each leaf's seed taken from
    ``zlib.crc32`` of its path.  The reference seeds a leaf with
    ``hash(path)``, and ``hash`` of a str is salted per process
    (``PYTHONHASHSEED``): every pytest worker drew other weights, and at
    about 1 draw in 36 a float32 decode logit of olmo-1b fell 1.03x outside
    ``F32_TOL``.  Both packages are a few ulps from float64 after every
    block; the tied lm head's 64-term dot carries that into ~1e-5 on a
    logit near 0, on either side (``scripts/olmo_decode_witness.py``)."""
    def leaf(path, spec):
        if spec.init in ("zeros", "ones"):
            return (jnp.zeros if spec.init == "zeros" else jnp.ones)(
                spec.shape, spec.dtype)
        k = jax.random.fold_in(key, zlib.crc32("/".join(path).encode())
                               % (2 ** 31))
        std = spec.scale if spec.scale is not None else 1.0 \
            if spec.init == "embed" else (
                spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
            ) ** -0.5
        return (jax.random.normal(k, spec.shape, jnp.float32) * std
                ).astype(spec.dtype)
    return j_map_specs(tree, leaf)


def _params(jcfg, dtype: str = "bfloat16"):
    pj = _j_init(JR.specs(jcfg), KEY)
    if dtype == "float32":
        pj = jax.tree.map(lambda a: a.astype(jnp.float32), pj)
    return pj, interop.params_from_jax(jax.tree.map(np.asarray, pj), CPU)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _batch(vocab, B, S, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (B, S)).astype(np.int32),
            "labels": rng.integers(0, vocab, (B, S)).astype(np.int32)}


# ----------------------------------------------------------------------
# configs, specs, parameters
# ----------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_are_the_reference_data(arch):
    j, t = J_REGISTRY[arch], REGISTRY[arch]
    for jc, tc in ((j, t), (j.reduced(), t.reduced())):
        a, b = dataclasses.asdict(jc), dataclasses.asdict(tc)
        assert a.pop("dtype") == jnp.bfloat16
        assert b.pop("dtype") == torch.bfloat16
        assert a == b
        assert jc.param_counts() == tc.param_counts()
        assert (jc.padded_vocab, jc.head_dim_) == (tc.padded_vocab,
                                                   tc.head_dim_)


@pytest.mark.parametrize("arch", DENSE)
def test_dense_specs_match_reference(arch):
    for jc, tc in ((J_REGISTRY[arch], REGISTRY[arch]),
                   _cfgs(arch)):
        js = {p: s for p, s in j_paths(JR.specs(jc))}
        ts = {p: s for p, s in tree_paths(R.specs(tc))}
        assert js.keys() == ts.keys()
        for p, s in ts.items():
            assert (s.shape, s.axes, s.init, s.scale) == \
                (js[p].shape, js[p].axes, js[p].init, js[p].scale), p
            assert s.dtype == torch.bfloat16 and js[p].dtype == jnp.bfloat16
        assert count_params(R.specs(tc)) == sum(
            int(np.prod(s.shape)) for s in js.values())


def test_init_params_is_deterministic_and_scaled():
    jc, tc = _cfgs("llama3-8b")
    specs = R.specs(tc)
    a = init_params(specs, 0, "cpu")
    b = init_params(specs, 0, "cpu")
    c = init_params(specs, 1, "cpu")
    pj = j_init(JR.specs(jc), KEY)
    flat_j = dict(jax.tree_util.tree_flatten_with_path(pj)[0])
    assert len(flat_j) == len(list(tree_paths(specs)))
    for path, spec in tree_paths(specs):
        x = a
        for k in path:
            x = x[k]
        y, z = b, c
        for k in path:
            y, z = y[k], z[k]
        assert x.shape == spec.shape and x.dtype == torch.bfloat16
        assert torch.equal(x, y)
        if spec.init in ("zeros", "ones"):
            assert torch.equal(x, torch.full_like(x, float(spec.init ==
                                                           "ones")))
            continue
        assert not torch.equal(x, z)
        std = spec.scale if spec.scale is not None else (
            spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
        ) ** -0.5
        assert abs(float(x.float().std()) / std - 1) < 0.1, path


def test_params_from_jax_keeps_bits_and_dtypes():
    jc, _ = _cfgs("olmo-1b")
    pj, pt = _params(jc)
    for (_, ja), ta in zip(jax.tree_util.tree_flatten_with_path(pj)[0],
                              jax.tree.leaves(pt)):
        assert ta.dtype == torch.bfloat16 and tuple(ta.shape) == ja.shape
        np.testing.assert_array_equal(
            np.asarray(ja).view(np.uint16),
            ta.view(torch.int16).numpy().view(np.uint16))
    f32 = interop.params_from_jax({"a": {"b": np.ones((2, 3), np.float32)}},
                                  "cpu")
    assert f32["a"]["b"].dtype == torch.float32


# ----------------------------------------------------------------------
# layer by layer, float32
# ----------------------------------------------------------------------

@pytest.mark.parametrize("norm", ["rms", "ln", "ln_nonparam"])
def test_apply_norm(norm):
    jc, tc = _cfgs("llama3-8b", "float32", norm=norm)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 8, jc.d_model)).astype(np.float32) * 3 + 1
    p = {"scale": rng.uniform(0.5, 1.5, jc.d_model).astype(np.float32),
         "bias": rng.standard_normal(jc.d_model).astype(np.float32)}
    if norm == "rms":
        p.pop("bias")
    if norm == "ln_nonparam":
        p = {}
    want = jl.apply_norm({k: jnp.asarray(v) for k, v in p.items()},
                         jnp.asarray(x), jc)
    got = tl.apply_norm({k: torch.from_numpy(v) for k, v in p.items()},
                        torch.from_numpy(x), tc)
    np.testing.assert_allclose(_np(got), _np(want), atol=F32_TOL,
                               rtol=F32_TOL)


def test_apply_rope():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 16, 4, 32)).astype(np.float32)
    pos = rng.integers(0, 1000, (2, 16)).astype(np.int32)
    want = jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), 5e5)
    got = tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 5e5)
    np.testing.assert_allclose(_np(got), _np(want), atol=F32_TOL,
                               rtol=F32_TOL)


@pytest.mark.parametrize("mlp_type", ["swiglu", "gelu"])
def test_apply_mlp(mlp_type):
    jc, tc = _cfgs("llama3-8b", "float32", mlp_type=mlp_type)
    rng = np.random.default_rng(3)
    d, f = jc.d_model, jc.d_ff
    p = {"w_up": rng.standard_normal((d, f)) * d ** -0.5,
         "w_gate": rng.standard_normal((d, f)) * d ** -0.5,
         "w_down": rng.standard_normal((f, d)) * f ** -0.5}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((2, 8, d)).astype(np.float32)
    want = jl.apply_mlp({k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(x), jc)
    got = tl.apply_mlp({k: torch.from_numpy(v) for k, v in p.items()},
                       torch.from_numpy(x), tc)
    np.testing.assert_allclose(_np(got), _np(want), atol=F32_TOL,
                               rtol=F32_TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("Sq,chunk", [(64, 16), (48, 32)])
def test_gqa_scores_full(causal, Sq, chunk):
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, Sq, 8, 16)).astype(np.float32)
    k = rng.standard_normal((2, Sq, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, Sq, 2, 16)).astype(np.float32)
    want = jl._gqa_scores_full(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal, q_offset=0,
                               chunk=chunk)
    got = tl._gqa_scores_full(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal, q_offset=0,
                              chunk=chunk)
    np.testing.assert_allclose(_np(got), _np(want), atol=F32_TOL,
                               rtol=F32_TOL)


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_gqa_decode(cache_dtype):
    rng = np.random.default_rng(5)
    q = rng.standard_normal((3, 1, 8, 16)).astype(np.float32)
    kc = rng.standard_normal((3, 24, 2, 16)).astype(np.float32)
    vc = rng.standard_normal((3, 24, 2, 16)).astype(np.float32)
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[cache_dtype]
    td = {"float32": torch.float32, "bfloat16": torch.bfloat16}[cache_dtype]
    want = jl._gqa_decode(jnp.asarray(q), jnp.asarray(kc).astype(jd),
                          jnp.asarray(vc).astype(jd), jnp.asarray(17))
    got = tl._gqa_decode(torch.from_numpy(q), torch.from_numpy(kc).to(td),
                         torch.from_numpy(vc).to(td),
                         torch.tensor(17, dtype=torch.int32))
    np.testing.assert_allclose(_np(got), _np(want), atol=F32_TOL,
                               rtol=F32_TOL)


# ----------------------------------------------------------------------
# model against model
# ----------------------------------------------------------------------

# bf16: activations round to 8 mantissa bits at other places in the two
# frameworks; over 2 layers and a mean of 256 token losses that moves the
# loss by ~1e-4 relative (measured 6.7e-5).  The bound is the one
# tests/test_kernel_integration.py allows between the reference's own
# two routes.
LOSS_TOL = {"float32": F32_TOL, "bfloat16": 5e-3}


# the dense configs: olmo-1b, ln_nonparam and tied embeddings; llama3-8b,
# GQA (4 query heads over 2 KV heads); granite-20b, learned positions, QKV
# bias, LayerNorm, GELU and MQA (4 query heads over 1); qwen2-72b, QKV bias
# and RoPE at theta 1e6
LLM_ARCHS = ["olmo-1b", "llama3-8b", "granite-20b", "qwen2-72b"]


@pytest.mark.parametrize("route", ["plain", "pallas-interpret"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", LLM_ARCHS)
def test_loss_fn_matches_reference(arch, dtype, route, monkeypatch):
    """S=128 so that the reference's kernel route
    (``REPRO_USE_PALLAS=interpret``) takes the Pallas kernel."""
    if route == "pallas-interpret":
        monkeypatch.setenv("REPRO_USE_PALLAS", "interpret")
    jc, tc = _cfgs(arch, dtype)
    pj, pt = _params(jc, dtype)
    b = _batch(jc.vocab, 2, 128)
    want = float(JR.loss_fn(pj, {k: jnp.asarray(v) for k, v in b.items()},
                            jc))
    got = R.loss_fn(pt, b, tc, device="cpu")
    assert got.dtype == torch.float32 and np.isfinite(float(got))
    assert float(got) == pytest.approx(want, rel=LOSS_TOL[dtype])


@pytest.mark.parametrize("arch", LLM_ARCHS)
def test_prefill_then_decode_matches_reference(arch):
    jc, tc = _cfgs(arch, "float32")
    pj, pt = _params(jc, "float32")
    toks = _batch(jc.vocab, 2, 12)["tokens"]
    jl_, jcache = JR.prefill(pj, {"tokens": jnp.asarray(toks)}, jc, 20)
    tl_, tcache = R.prefill(pt, {"tokens": toks}, tc, 20, device="cpu")
    assert tl_.shape == (2, 1, tc.padded_vocab)
    assert tcache["k"].shape == (tc.n_layers, 2, 20, tc.n_kv_heads,
                                 tc.head_dim_)
    np.testing.assert_allclose(_np(tl_), _np(jl_), atol=F32_TOL,
                               rtol=F32_TOL)
    np.testing.assert_array_equal(tcache["length"].numpy(),
                                  np.asarray(jcache["length"]))
    rng = np.random.default_rng(6)
    for _ in range(3):
        tok = rng.integers(0, jc.vocab, (2, 1)).astype(np.int32)
        jl_, jcache = JR.decode_step(pj, {"tokens": jnp.asarray(tok)},
                                     jcache, jc)
        tl_, tcache = R.decode_step(pt, {"tokens": tok}, tcache, tc,
                                    device="cpu")
        np.testing.assert_allclose(_np(tl_), _np(jl_), atol=F32_TOL,
                                   rtol=F32_TOL)
    np.testing.assert_allclose(_np(tcache["k"]), _np(jcache["k"]),
                               atol=F32_TOL, rtol=F32_TOL)
    assert int(tcache["length"][0]) == 15


@pytest.mark.parametrize("arch", ["olmo-1b", "llama3-8b"])
def test_prefill_matches_decode_path(arch):
    """tests/test_archs_smoke.py::test_prefill_matches_decode_path on the
    port: decoding token t with the cache of the prefix matches the
    full-sequence forward at t (bf16, the reference's 3e-2)."""
    _, tc = _cfgs(arch)
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
    uids = [eng.submit(p, max_new=6) for p in prompts]
    done = eng.run(max_steps=100)
    assert sorted(r.uid for r in done) == sorted(set(uids))
    return {r.uid: list(r.generated) for r in done}


def test_serve_engine_tokens_match_reference():
    """3 requests into 2 slots (recycling and whole-batch re-prefill with
    left padding), greedy, float32: the tokens are identical."""
    jc, tc = _cfgs("llama3-8b", "float32")
    pj, pt = _params(jc, "float32")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, jc.vocab, n) for n in (5, 8, 11)]
    want = _serve(JServeEngine, jc, pj, prompts)
    before = flash_attention.launches
    got = _serve(ServeEngine, tc, pt, prompts, device="cpu")
    assert got == want
    assert flash_attention.launches == before


def test_serve_engine_finishes_in_bf16():
    _, tc = _cfgs("olmo-1b")
    params = init_params(R.specs(tc), 0, "cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, tc.vocab, 8) for _ in range(3)]
    got = _serve(ServeEngine, tc, params, prompts, device="cpu")
    assert len(got) == 3
    for toks in got.values():
        assert len(toks) == 6 and all(0 <= t < tc.vocab for t in toks)


def test_llmserve_cli_on_cpu(capsys):
    assert llmserve.main(["--arch", "llama3-8b", "--requests", "2",
                          "--prompt-len", "8", "--gen", "4",
                          "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "prefill 2x8" in out and "decoded 3 steps" in out
