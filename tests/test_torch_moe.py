"""Port of the moe family (moonshot-v1-16b-a3b: 2 shared experts; dbrx-132b:
GQA and no shared expert; both reduced) against the JAX package's: specs,
the routing's tie order, ``apply_moe`` in float32 (with and without shared
experts, with capacity overflow, with forced ties), the load-balance loss,
``loss_fn`` on both of the reference's attention routes, prefill then
decode, the serving engine and its CLI, and the sliced draw of leaves too
large to draw whole.  Weights are drawn by the JAX package (a per-path seed
that is the same in every process) and carried over with
``interop.params_from_jax``; inputs are made with numpy from a seed.  One
train step of each is held in ``tests/test_torch_training.py``."""
import math
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import REGISTRY as J_REGISTRY  # noqa: E402
from repro.inference import ServeEngine as JServeEngine  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro.models.param import map_specs as j_map_specs  # noqa: E402
from repro.models.param import tree_paths as j_paths  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import REGISTRY  # noqa: E402
from repro_torch.inference import ServeEngine  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.launch import llmserve  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import param as tparam  # noqa: E402
from repro_torch.models import registry as R  # noqa: E402
from repro_torch.models.param import (count_params, init_params,  # noqa: E402
                                      tree_paths)

MOE = ("moonshot-v1-16b-a3b", "dbrx-132b")
KEY = jax.random.PRNGKey(0)
CPU = torch.device("cpu")
# float32: the two packages sum in other orders (BLAS blocking, XLA
# fusion), a few ulps per op on values of order 1
F32_TOL = 1e-5
# bf16 loss: the reference's own two attention routes' bound
# (tests/test_kernel_integration.py), as for the other families
LOSS_TOL = {"float32": F32_TOL, "bfloat16": 5e-3}
JD = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TD = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _cfgs(arch: str, dtype: str = "bfloat16", **kw):
    """The reduced config in both packages (4 experts, top-2, d_ff 32);
    dbrx keeps GQA (its ``reduced()`` has 4 query heads over 4)."""
    if arch == "dbrx-132b":
        kw.setdefault("n_kv_heads", 2)
    return (J_REGISTRY[arch].reduced().replace(dtype=JD[dtype], **kw),
            REGISTRY[arch].reduced().replace(dtype=TD[dtype], **kw))


def _j_init(tree, key) -> dict:
    """Every leaf drawn by JAX from a seed that ``zlib.crc32`` takes from
    its path (the reference's own ``hash(path)`` is salted per process),
    at the reference's init scale; the norms N(1, 0.3), so that their
    path is exercised too."""
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


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol=F32_TOL):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def _batch(vocab, B, S, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (B, S)).astype(np.int32),
            "labels": rng.integers(0, vocab, (B, S)).astype(np.int32)}


# ----------------------------------------------------------------------
# specs and the draw
# ----------------------------------------------------------------------

@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", MOE)
def test_moe_specs_match_reference(arch, reduced):
    jc, tc = J_REGISTRY[arch], REGISTRY[arch]
    if reduced:
        jc, tc = jc.reduced(), tc.reduced()
    for js_tree, ts_tree in ((JR.specs(jc), R.specs(tc)),
                             (jmoe.moe_specs(jc, 3), tmoe.moe_specs(tc, 3)),
                             (jmoe.moe_specs(jc), tmoe.moe_specs(tc))):
        js, ts = dict(j_paths(js_tree)), dict(tree_paths(ts_tree))
        assert list(js) == list(ts)
        for p, s in ts.items():
            assert (s.shape, s.axes, s.init, s.scale) == \
                (js[p].shape, js[p].axes, js[p].init, js[p].scale), p
            assert s.dtype == torch.bfloat16 and js[p].dtype == jnp.bfloat16
    assert count_params(R.specs(tc)) == sum(
        int(np.prod(s.shape)) for _, s in j_paths(JR.specs(jc)))
    shared = {"shared_up", "shared_gate", "shared_down"}
    assert (shared <= set(R.specs(tc)["blocks"]["mlp"])) == \
        (arch == "moonshot-v1-16b-a3b")


# the configs the card runs at full width from earlier slices
ON_CARD = ("llama3-8b", "olmo-1b", "phi-3-vision-4.2b", "rwkv6-1.6b",
           "zamba2-7b")


def test_only_moe_leaves_are_drawn_in_slices():
    """Every leaf of the configs already run on the card has at most
    ``SLICED_DRAW`` elements, so their draws stay whole and unchanged;
    moonshot's expert stacks are above it."""
    for arch in ON_CARD:
        big = max(math.prod(s.shape) for _, s in
                  tree_paths(R.specs(REGISTRY[arch])))
        assert big <= tparam.SLICED_DRAW, arch
    sizes = {"/".join(p): math.prod(s.shape) for p, s in
             tree_paths(R.specs(REGISTRY["moonshot-v1-16b-a3b"]))}
    assert {p for p, n in sizes.items() if n > tparam.SLICED_DRAW} == {
        "blocks/mlp/w_up", "blocks/mlp/w_gate", "blocks/mlp/w_down"}


def test_sliced_draw_is_deterministic_and_scaled(monkeypatch):
    """A leaf above the bound (lowered here) is drawn a leading slice at a
    time: the same every call, its own per seed, at the fan-in scale, and
    leaves under the bound keep their whole draw."""
    _, tc = _cfgs("moonshot-v1-16b-a3b")
    specs = R.specs(tc)
    whole = init_params(specs, 0, "cpu")
    monkeypatch.setattr(tparam, "SLICED_DRAW", 4096)
    draws = []
    randn = torch.randn

    def counted(shape, **kw):
        draws.append(tuple(shape))
        return randn(shape, **kw)
    monkeypatch.setattr(torch, "randn", counted)
    a, b = (init_params(specs, s, "cpu") for s in (0, 0))
    c = init_params(specs, 1, "cpu")
    drawn = [s for _, s in tree_paths(specs) if s.init not in ("zeros",
                                                               "ones")]
    assert len(draws) == 3 * sum(s.shape[0] if math.prod(s.shape) > 4096
                                 else 1 for s in drawn)
    for path, spec in tree_paths(specs):
        x, y, z, w = a, b, c, whole
        for k in path:
            x, y, z, w = x[k], y[k], z[k], w[k]
        assert x.shape == spec.shape and x.dtype == torch.bfloat16
        assert torch.equal(x, y)
        if math.prod(spec.shape) <= 4096:
            assert torch.equal(x, w), path
            continue
        assert not torch.equal(x, z), path
        std = spec.scale or spec.shape[-2] ** -0.5
        assert float(x.float().std()) == pytest.approx(std, rel=0.1), path


# ----------------------------------------------------------------------
# routing and the layer, float32
# ----------------------------------------------------------------------

def test_route_breaks_ties_as_jax_top_k():
    """Logits rounded to a few values tie everywhere; the experts chosen
    and their order are ``jax.lax.top_k``'s (the lower index first among
    equals), and so are the gates."""
    rng = np.random.default_rng(1)
    logits = np.round(rng.standard_normal((3, 50, 16)) * 2) / 2
    logits = logits.astype(np.float32)
    for k in (1, 2, 4, 6):
        gates, idx = tmoe.route(torch.from_numpy(logits), k)
        jg, ji = jax.lax.top_k(jax.nn.softmax(jnp.asarray(logits), -1), k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
        np.testing.assert_allclose(gates.numpy(), np.asarray(jg), rtol=1e-6,
                                   atol=1e-7)


def _layer(jc, ties: bool = False):
    """One layer's MoE weights (the layer axis dropped) in both packages;
    with ``ties``, router columns 0 and 1 are both zero, so those two
    experts' logits tie exactly on every token and the tie order decides
    which of them a token takes."""
    pj = jax.tree.map(lambda a: a[0].astype(jnp.float32),
                      _j_init(jmoe.moe_specs(jc, 1), KEY))
    if ties:
        pj["router"] = pj["router"].at[:, :2].set(0.0)
    return pj, {k: torch.from_numpy(np.array(v)) for k, v in pj.items()}


MOE_CASES = {
    "shared": ("moonshot-v1-16b-a3b", {}, False),
    "no-shared": ("dbrx-132b", {}, False),
    "overflow": ("moonshot-v1-16b-a3b", {"capacity_factor": 0.5}, False),
    "overflow-no-shared": ("dbrx-132b", {"capacity_factor": 0.5}, False),
    "ties": ("moonshot-v1-16b-a3b", {}, True),
    "ties-overflow": ("dbrx-132b", {"capacity_factor": 0.5}, True),
}


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_apply_moe_matches_reference(case):
    """B=2, S=24 over 4 experts, top-2: cap = int(24 * 2 / 4 * 1.25) = 15
    places an expert, 6 with ``capacity_factor`` 0.5, where tokens
    overflow; the JAX layer's output at 1e-5."""
    arch, kw, ties = MOE_CASES[case]
    jc, tc = _cfgs(arch, "float32", **kw)
    pj, pt = _layer(jc, ties)
    x = np.random.default_rng(2).standard_normal(
        (2, 24, jc.d_model)).astype(np.float32)
    want = jmoe.apply_moe(pj, jnp.asarray(x), jc)
    got = tmoe.apply_moe(pt, torch.from_numpy(x), tc)
    assert got.dtype == torch.float32 and got.shape == x.shape
    _close(got, want)
    # what the case is for: choices dropped by capacity, and tokens whose
    # top-k crosses the tie (expert 0 taken before 1)
    logits = torch.from_numpy(x) @ pt["router"]
    _, idx = tmoe.route(logits, tc.top_k)
    per = torch.stack([(idx == e).sum((1, 2)) for e in range(4)])
    cap = max(1, int(24 * tc.top_k / 4 * tc.capacity_factor))
    if "overflow" in case:
        assert int(per.max()) > 2 * cap
    if ties:
        one = (idx == 0).any(-1) ^ (idx == 1).any(-1)
        assert bool(one.any()) and not bool((idx == 1).any(-1)[
            ~(idx == 0).any(-1)].any())


def test_apply_moe_in_bf16_matches_reference():
    """bf16 activations and weights, where router logits tie often: the
    layer within bf16's rounding of the reference's."""
    jc, tc = _cfgs("moonshot-v1-16b-a3b", "bfloat16")
    pj, _ = _layer(jc)
    pj = jax.tree.map(lambda a: a.astype(jnp.bfloat16), pj)
    pt = interop.params_from_jax(jax.tree.map(np.asarray, pj), CPU)
    x = np.random.default_rng(3).standard_normal(
        (2, 24, jc.d_model)).astype(np.float32)
    want = jmoe.apply_moe(pj, jnp.asarray(x, jnp.bfloat16), jc)
    got = tmoe.apply_moe(pt, torch.from_numpy(x).to(torch.bfloat16), tc)
    assert got.dtype == torch.bfloat16
    _close(got, want, tol=2e-2)


def test_aux_load_balance_loss_matches_reference():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((2, 24, 8)).astype(np.float32)
    idx = rng.integers(0, 8, (2, 24, 3)).astype(np.int32)
    want = jmoe.aux_load_balance_loss(jnp.asarray(logits), jnp.asarray(idx),
                                      8)
    got = tmoe.aux_load_balance_loss(torch.from_numpy(logits),
                                     torch.from_numpy(idx), 8)
    assert got.dtype == torch.float32 and got.dim() == 0
    _close(got, want, tol=1e-6)


# ----------------------------------------------------------------------
# model against model
# ----------------------------------------------------------------------

@pytest.mark.parametrize("route", ["plain", "pallas-interpret"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE)
def test_loss_fn_matches_reference(arch, dtype, route, monkeypatch):
    """S=128 so that the reference's kernel route
    (``REPRO_USE_PALLAS=interpret``) takes the Pallas flash kernel."""
    if route == "pallas-interpret":
        monkeypatch.setenv("REPRO_USE_PALLAS", "interpret")
    jc, tc = _cfgs(arch, dtype)
    pj, pt = _params(jc, dtype)
    b = _batch(jc.vocab, 2, 128)
    want = float(JR.loss_fn(pj, {k: jnp.asarray(v) for k, v in b.items()},
                            jc))
    before = flash_attention.launches
    got = R.loss_fn(pt, b, tc, device="cpu")
    assert got.dtype == torch.float32 and np.isfinite(float(got))
    assert float(got) == pytest.approx(want, rel=LOSS_TOL[dtype])
    assert flash_attention.launches == before


@pytest.mark.parametrize("arch", MOE)
def test_prefill_then_decode_matches_reference(arch):
    """Prefill 12 tokens into a cache of 20 (the pad positions count
    against capacity, as in the reference), then 3 decode steps (S = 1:
    cap 1, the k distinct experts never overflow); logits and the KV
    cache at 1e-5."""
    jc, tc = _cfgs(arch, "float32")
    pj, pt = _params(jc, "float32")
    toks = _batch(jc.vocab, 2, 12)["tokens"]
    jl_, jcache = JR.prefill(pj, {"tokens": jnp.asarray(toks)}, jc, 20)
    tl_, tcache = R.prefill(pt, {"tokens": toks}, tc, 20, device="cpu")
    assert tl_.shape == (2, 1, tc.padded_vocab)
    assert tcache["k"].shape == (tc.n_layers, 2, 20, tc.n_kv_heads,
                                 tc.head_dim_)
    _close(tl_, jl_)
    rng = np.random.default_rng(6)
    for _ in range(3):
        tok = rng.integers(0, jc.vocab, (2, 1)).astype(np.int32)
        jl_, jcache = JR.decode_step(pj, {"tokens": jnp.asarray(tok)},
                                     jcache, jc)
        tl_, tcache = R.decode_step(pt, {"tokens": tok}, tcache, tc,
                                    device="cpu")
        _close(tl_, jl_)
    for name in ("k", "v"):
        _close(tcache[name], jcache[name])
    np.testing.assert_array_equal(tcache["length"].numpy(),
                                  np.asarray(jcache["length"]))
    assert int(tcache["length"][0]) == 15


def _serve(engine_cls, cfg, params, prompts, **kw):
    eng = engine_cls(cfg, params, slots=2, max_len=64, **kw)
    uids = [eng.submit(p, max_new=6) for p in prompts]
    done = eng.run(max_steps=100)
    assert sorted(r.uid for r in done) == sorted(set(uids))
    return {r.uid: list(r.generated) for r in done}


@pytest.mark.parametrize("arch", MOE)
def test_serve_engine_tokens_match_reference(arch):
    """3 requests into 2 slots (recycling and whole-batch re-prefill with
    left padding, whose pad tokens take expert places), greedy, float32:
    the tokens are identical."""
    jc, tc = _cfgs(arch, "float32")
    pj, pt = _params(jc, "float32")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, jc.vocab, n) for n in (5, 8, 11)]
    want = _serve(JServeEngine, jc, pj, prompts)
    before = flash_attention.launches
    got = _serve(ServeEngine, tc, pt, prompts, device="cpu")
    assert got == want
    assert flash_attention.launches == before


def test_llmserve_cli_on_cpu(capsys):
    assert llmserve.main(["--arch", "moonshot-v1-16b-a3b", "--requests",
                          "2", "--prompt-len", "8", "--gen", "4",
                          "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "prefill 2x8" in out and "decoded 3 steps" in out
