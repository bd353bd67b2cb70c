"""Port of the encoder-decoder path (seamless-m4t-medium, reduced: 2 + 2
layers, d_model 64, 4 heads of 16, vocab 128, chunk 16) against the JAX
package's: specs and the parameter count, the encoder, the cross K/V and
cross-attention in float32, ``loss_fn`` on both of the reference's
attention routes, frames and tokens of other lengths, prefill then decode
with both caches, and the two CLIs.  Weights are drawn with numpy (a
per-path seed that is the same in every process) into the reference's
tree and carried over with ``interop.params_from_jax``; inputs are made
with numpy from a seed.  On
CPU tensors the attention takes its plain version, so nothing here
launches a kernel."""
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import REGISTRY as J_REGISTRY  # noqa: E402
from repro.launch import train as j_train_cli  # noqa: E402
from repro.models import encdec as jed  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro.models.param import map_specs as j_map_specs  # noqa: E402
from repro.models.param import tree_paths as j_paths  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import REGISTRY  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.launch import llmserve  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import encdec as ted  # noqa: E402
from repro_torch.models import registry as R  # noqa: E402
from repro_torch.models.param import count_params, tree_paths  # noqa: E402

ARCH = "seamless-m4t-medium"
CPU = torch.device("cpu")
# float32 throughout: the two packages sum in other orders (BLAS blocking,
# XLA fusion), a few ulps per op on values of order 1
F32_TOL = 1e-5
# bf16: activations round to 8 mantissa bits at other places in the two
# frameworks; tests/test_kernel_integration.py's bound between the
# reference's own two routes, as for the other families
LOSS_TOL = {"float32": F32_TOL, "bfloat16": 5e-3}
JD = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TD = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _cfgs(dtype: str = "float32"):
    return (J_REGISTRY[ARCH].reduced().replace(dtype=JD[dtype]),
            REGISTRY[ARCH].reduced().replace(dtype=TD[dtype]))


def _params(jcfg, dtype: str):
    """The reference's parameter tree, each leaf drawn with numpy from a
    seed that ``zlib.crc32`` takes from its path (the reference's own
    ``hash(path)`` is salted per process), as JAX arrays in ``dtype``, and
    the port's, carried across by ``interop.params_from_jax``.  N(0, 1) at
    the reference's init scale; the LayerNorm scales and biases, ones and
    zeros at init, get N(0, 0.3) around that value, so that both of their
    paths are exercised."""
    def leaf(path, spec):
        rng = np.random.default_rng(zlib.crc32("/".join(path).encode()))
        x = rng.standard_normal(spec.shape).astype(np.float32)
        if spec.init in ("zeros", "ones"):
            x = float(spec.init == "ones") + 0.3 * x
        else:
            x = x * np.float32(spec.scale if spec.scale is not None else 1.0
                               if spec.init == "embed" else (
                                   spec.shape[-2] if len(spec.shape) >= 2
                                   else spec.shape[-1]) ** -0.5)
        return jnp.asarray(x, JD[dtype])
    pj = j_map_specs(JR.specs(jcfg), leaf)
    return pj, interop.params_from_jax(jax.tree.map(np.asarray, pj), CPU)


@pytest.fixture(scope="module")
def f32():
    """(JAX config, port config, JAX params, port params) in float32."""
    jc, tc = _cfgs("float32")
    return (jc, tc) + _params(jc, "float32")


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol=F32_TOL):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def _batch(cfg, B, S, frames=None, seed=0):
    """Tokens and labels (B, S) and float32 frames (B, frames or S,
    frontend_dim) ~ N(0, 1)."""
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
            "frontend": rng.normal(size=(B, frames or S, cfg.frontend_dim)
                                   ).astype(np.float32)}


def _j(batch) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _j_loss(jc, pj, batch) -> float:
    """The reference's ``loss_fn``, jitted (its route is read at trace
    time)."""
    return float(jax.jit(lambda p, b: JR.loss_fn(p, b, jc))(pj, _j(batch)))


def _layer(tree, i: int):
    """Layer ``i`` of a stacked (sub)tree, in either package."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


# ----------------------------------------------------------------------
# specs
# ----------------------------------------------------------------------

@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_encdec_specs_match_reference(reduced):
    jc, tc = J_REGISTRY[ARCH], REGISTRY[ARCH]
    if reduced:
        jc, tc = jc.reduced(), tc.reduced()
    js = dict(j_paths(JR.specs(jc)))
    ts = dict(tree_paths(R.specs(tc)))
    assert js.keys() == ts.keys()
    for p, s in ts.items():
        assert (s.shape, s.axes, s.init, s.scale) == \
            (js[p].shape, js[p].axes, js[p].init, js[p].scale), p
        assert s.dtype == torch.bfloat16 and js[p].dtype == jnp.bfloat16
    n = count_params(R.specs(tc))
    assert n == sum(int(np.prod(s.shape)) for s in js.values())
    if not reduced:
        assert n == 878_309_376


# ----------------------------------------------------------------------
# the parts in float32
# ----------------------------------------------------------------------

def test_encode_and_cross_attention_match_reference(f32):
    """``_encode`` on 24 frames (the chunked bidirectional path: 24 is no
    multiple of the chunk), then ``_cross_kv`` and ``_cross_apply`` of each
    decoder layer on the encoder's output."""
    jc, tc, pj, pt = f32
    b = _batch(jc, 2, 16, frames=24, seed=1)
    want = jax.jit(lambda p, f: jed._encode(p, f, jc))(
        pj, jnp.asarray(b["frontend"]))
    got = ted._encode(pt, torch.from_numpy(b["frontend"]), tc)
    assert got.shape == (2, 24, tc.d_model)
    _close(got, want)
    x = np.random.default_rng(2).normal(size=(2, 16, jc.d_model)).astype(
        np.float32)
    j_kv = jax.jit(lambda pl, e: jed._cross_kv(pl, e, jc))
    j_apply = jax.jit(lambda pl, x, k, v: jed._cross_apply(pl, x, k, v, jc))
    for i in range(jc.n_dec_layers):
        plj, plt = _layer(pj["dec_blocks"], i), _layer(pt["dec_blocks"], i)
        jk, jv = j_kv(plj, want)
        tk, tv = ted._cross_kv(plt, got, tc)
        _close(tk, jk)
        _close(tv, jv)
        _close(ted._cross_apply(plt, torch.from_numpy(x), tk, tv, tc),
               j_apply(plj, jnp.asarray(x), jk, jv))


# ----------------------------------------------------------------------
# model against model
# ----------------------------------------------------------------------

@pytest.mark.parametrize("dtype,route", [
    ("float32", "plain"), ("float32", "pallas-interpret"),
    ("bfloat16", "plain")])
def test_loss_fn_matches_reference(dtype, route, f32, monkeypatch):
    """128 frames and 128 tokens, so that the reference's kernel route
    (``REPRO_USE_PALLAS=interpret``) takes the Pallas kernel in the
    encoder (bidirectional) and in the decoder's self-attention (causal):
    both routes in float32, the plain one in bf16."""
    if route == "pallas-interpret":
        monkeypatch.setenv("REPRO_USE_PALLAS", "interpret")
    jc, tc, pj, pt = f32 if dtype == "float32" else \
        _cfgs(dtype) + _params(_cfgs(dtype)[0], dtype)
    b = _batch(jc, 2, 128)
    want = _j_loss(jc, pj, b)
    before = flash_attention.launches
    got = R.loss_fn(pt, b, tc, device="cpu")
    assert got.dtype == torch.float32 and np.isfinite(float(got))
    assert float(got) == pytest.approx(want, rel=LOSS_TOL[dtype])
    assert flash_attention.launches == before


def test_loss_fn_frames_and_tokens_of_other_lengths(f32):
    """24 frames under 16 tokens: the cross-attention's keys outnumber its
    queries, and neither length is a multiple of 128."""
    jc, tc, pj, pt = f32
    b = _batch(jc, 2, 16, frames=24, seed=3)
    want = _j_loss(jc, pj, b)
    got = R.loss_fn(pt, b, tc, device="cpu")
    assert float(got) == pytest.approx(want, rel=F32_TOL)


def test_prefill_then_decode_matches_reference(f32):
    """24 frames and 12 prompt tokens into a cache of 20, then 3 decode
    steps: the logits of each at 1e-5; both caches' shapes and values, and
    the self-attention cache's ``length``, as the reference's."""
    jc, tc, pj, pt = f32
    b = _batch(jc, 2, 12, frames=24, seed=4)
    del b["labels"]
    jl_, jcache = jax.jit(lambda p, b: JR.prefill(p, b, jc, 20))(pj, _j(b))
    tl_, tcache = R.prefill(pt, b, tc, 20, device="cpu")
    assert tl_.shape == (2, 1, tc.padded_vocab)
    _close(tl_, jl_)
    j_step = jax.jit(lambda p, b, c: JR.decode_step(p, b, c, jc))
    rng = np.random.default_rng(6)
    for _ in range(3):
        tok = rng.integers(0, jc.vocab, (2, 1)).astype(np.int32)
        jl_, jcache = j_step(pj, {"tokens": jnp.asarray(tok)}, jcache)
        tl_, tcache = R.decode_step(pt, {"tokens": tok}, tcache, tc,
                                    device="cpu")
        assert tl_.shape == (2, 1, tc.padded_vocab)
        _close(tl_, jl_)
    assert tcache.keys() == jcache.keys() == {"self", "cross"}
    assert tcache["self"]["k"].shape == (tc.n_dec_layers, 2, 20,
                                         tc.n_kv_heads, tc.head_dim_)
    for k in ("k", "v"):
        assert tcache["self"][k].shape == jcache["self"][k].shape
        _close(tcache["self"][k], jcache["self"][k])
    np.testing.assert_array_equal(tcache["self"]["length"].numpy(),
                                  np.asarray(jcache["self"]["length"]))
    assert int(tcache["self"]["length"][0]) == 15
    assert len(tcache["cross"]) == len(jcache["cross"]) == 2
    for got, want in zip(tcache["cross"], jcache["cross"]):
        assert got.shape == want.shape == (tc.n_dec_layers, 2, 24,
                                           tc.n_kv_heads, tc.head_dim_)
        _close(got, want)


# ----------------------------------------------------------------------
# the CLIs
# ----------------------------------------------------------------------

def test_llmserve_cli_on_cpu(capsys):
    assert llmserve.main(["--arch", ARCH, "--requests", "2",
                          "--prompt-len", "16", "--gen", "4",
                          "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "prefill 2x16" in out and "decoded 3 steps" in out


def test_train_cli_on_cpu(tmp_path, capsys):
    assert train_cli.main(["--arch", ARCH, "--device", "cpu", "--steps",
                           "2", "--batch", "2", "--seq", "16",
                           "--ckpt-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "done: 2 steps" in out and "final loss" in out


def test_train_cli_batches_are_the_reference_cli_draws(tmp_path,
                                                       monkeypatch):
    """Both CLIs' ``batch_fn``, read through a loop that draws the batches
    of its steps and stops the CLI there: the frames (and tokens and
    labels) bit-equal.  The reference's weights are zeros here: the draws
    do not read them."""
    drawn = {}

    class Drawn(Exception):
        pass

    def drawing(name):
        class Loop:
            def __init__(self, *a, **kw):
                pass

            def run(self, state, batch_fn, start, steps):
                drawn[name] = [batch_fn(i) for i in range(start, steps)]
                raise Drawn
        return Loop
    monkeypatch.setattr(j_train_cli, "FaultTolerantLoop", drawing("jax"))
    monkeypatch.setattr(j_train_cli, "init_params", lambda specs, key: (
        j_map_specs(specs, lambda p, s: jnp.zeros(s.shape, s.dtype))))
    monkeypatch.setattr(train_cli, "FaultTolerantLoop", drawing("torch"))
    args = ["--arch", ARCH, "--steps", "3", "--batch", "2", "--seq", "16"]
    with pytest.raises(Drawn):
        j_train_cli.main(args + ["--ckpt-dir", str(tmp_path / "j")])
    with pytest.raises(Drawn):
        train_cli.main(args + ["--device", "cpu", "--ckpt-dir",
                               str(tmp_path / "t")])
    assert len(drawn["jax"]) == len(drawn["torch"]) == 3
    for want, got in zip(drawn["jax"], drawn["torch"]):
        assert got.keys() == want.keys() >= {"tokens", "labels", "frontend"}
        assert got["frontend"].shape == (2, 16, 32)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
