"""Training in the port against the JAX package: AdamW (schedule and one
update), int8 gradient compression (bit-equal), the synthetic data
pipeline (bit-equal), one train step of reduced olmo-1b, rwkv6-1.6b,
zamba2-7b, moonshot-v1-16b-a3b and dbrx-132b against
``jax.value_and_grad`` plus the reference's AdamW (olmo-1b also with 4
microbatches and with compressed gradients), checkpoints that cross
between the two packages bit-equal, and the port's own counterparts of
``tests/test_training.py``: the loss decreases, compression trains, a
crash restores identically, a straggler is flagged, and the train CLI
runs.  Weights are drawn by the JAX package with per-path crc32 seeds
(``_j_init``, as ``tests/test_torch_llm.py``) and carried over with
``interop.params_from_jax``; the JAX side runs each step once, jitted."""
import functools
import types
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import Checkpointer as JCheckpointer  # noqa: E402
from repro.configs import REGISTRY as J_REGISTRY  # noqa: E402
from repro.data import SyntheticLMDataset as JDataset  # noqa: E402
from repro.data import batch_for_step as j_batch_for_step  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro.models.param import map_specs as j_map_specs  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.training import TrainConfig as JTrainConfig  # noqa: E402
from repro.training import grad_compression as jgc  # noqa: E402
from repro.training import make_train_step as j_make_train_step  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.configs import REGISTRY  # noqa: E402
from repro_torch.data import SyntheticLMDataset, batch_for_step  # noqa: E402
from repro_torch.ft import FaultTolerantLoop, FTConfig  # noqa: E402
from repro_torch.ft import coordinator  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.training import (TrainConfig, grad_compression,  # noqa: E402
                                  init_train_state, make_train_step)
from repro_torch.tree import leaves  # noqa: E402

KEY = jax.random.PRNGKey(0)
CPU = torch.device("cpu")
# float32: the two packages sum in other orders (BLAS blocking, XLA
# fusion), a few ulps per op on values of order 1 (tests/test_torch_llm.py)
F32_TOL = 1e-5
# bf16 loss: the reference's own two attention routes' bound
BF16_LOSS_TOL = 5e-3
# the default lr (3e-4) from the first step on (no warmup)
OPT = adamw.AdamWConfig(warmup_steps=1)
J_OPT = jadamw.AdamWConfig(warmup_steps=1)
B, S = 4, 32  # rwkv6's reduced chunk is 16: S a multiple of it


def _j_init(tree, key) -> dict:
    """The JAX package's ``init_params`` with each leaf's seed taken from
    ``zlib.crc32`` of its path (the reference's ``hash(path)`` is salted
    per process); ``tests/test_torch_llm.py`` has the reasons."""
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


def _cfgs(arch: str, dtype: str):
    """Reduced configs in both packages; olmo-1b at vocab 64 as
    ``tests/test_training.py``."""
    kw = {"vocab": 64} if arch == "olmo-1b" else {}
    jd = {"bfloat16": jnp.bfloat16, "float32": jnp.float32}[dtype]
    td = {"bfloat16": torch.bfloat16, "float32": torch.float32}[dtype]
    return (J_REGISTRY[arch].reduced().replace(dtype=jd, **kw),
            REGISTRY[arch].reduced().replace(dtype=td, **kw))


@functools.lru_cache(maxsize=None)
def _j_params(arch: str, dtype: str):
    jc, _ = _cfgs(arch, dtype)
    pj = _j_init(JR.specs(jc), KEY)
    if dtype == "float32":
        pj = jax.tree.map(lambda a: a.astype(jnp.float32), pj)
    return pj


def _t_params(arch: str, dtype: str) -> dict:
    return interop.params_from_jax(
        jax.tree.map(np.asarray, _j_params(arch, dtype)), CPU)


def _batch(step=0, b=B, s=S, vocab=64) -> dict:
    return batch_for_step(step, global_batch=b, seq=s, vocab=vocab)


def _step_batch(cfg) -> dict:
    """The one-step tests' batch for ``cfg``: ``_batch`` at its vocab, and
    for the encoder-decoder float32 frames (B, S, frontend_dim) ~ N(0, 1)."""
    b = _batch(vocab=cfg.vocab)
    if cfg.is_encdec:
        b["frontend"] = np.random.default_rng(1).normal(
            size=(B, S, cfg.frontend_dim)).astype(np.float32)
    return b


@functools.lru_cache(maxsize=None)
def _j_value_and_grad(arch: str, dtype: str):
    """The reference's loss and gradients on ``_batch`` (jitted once)."""
    jc, _ = _cfgs(arch, dtype)
    vg = jax.jit(jax.value_and_grad(lambda p, b: JR.loss_fn(p, b, jc)))
    b = {k: jnp.asarray(v) for k, v in _step_batch(jc).items()}
    return vg(_j_params(arch, dtype), b)


_j_apply = jax.jit(jadamw.apply_updates, static_argnums=3)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol=F32_TOL, what=""):
    """Leaf by leaf at ``tol`` relative, and absolute ``tol`` times the
    leaf's largest value where that exceeds 1: float32 sums err in
    proportion to their terms (rwkv6's bonus ``u`` has gradients up to
    ~22, summed over every token)."""
    g, w = leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w), what
    for i, (a, b) in enumerate(zip(g, w)):
        assert tuple(a.shape) == tuple(b.shape), (what, i)
        b = _np(b)
        np.testing.assert_allclose(
            _np(a), b, rtol=tol, atol=tol * max(1.0, float(np.abs(b).max(
                initial=0.0))), err_msg=f"{what} leaf {i}")


def _close_params(got, want, mu_ref, lr: float):
    """Updated params at ``F32_TOL``, but where AdamW's first step is
    ill-conditioned: there it maps the clipped gradient g to
    g / (|g| + eps), which amplifies the packages' ~1e-9 gradient
    differences by up to 1 / eps = 1e8 where |g| is near eps.  Those
    elements (0 < |g| < 1e-7, read from the reference's first moment
    mu = 0.1 g; the gradients themselves are compared apart) are held to
    one step, 2 lr (1 + wd |p|), instead."""
    for a, b, mu in zip(leaves(got), jax.tree.leaves(want),
                        jax.tree.leaves(mu_ref)):
        a, b, mu = _np(a), _np(b), np.asarray(mu)
        ill = (np.abs(mu) < 1e-8) & (mu != 0)
        np.testing.assert_allclose(a[~ill], b[~ill], rtol=F32_TOL,
                                   atol=F32_TOL)
        assert np.all(np.abs(a - b)[ill] <= 2 * lr * (1 + 0.1 * np.abs(
            b[ill])))


# ----------------------------------------------------------------------
# AdamW and gradient compression, op for op
# ----------------------------------------------------------------------

def _small_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"b": {"w": rng.standard_normal((6, 5)).astype(np.float32)},
            "a": rng.standard_normal((7,)).astype(np.float32)}


@pytest.mark.parametrize("cfg", [
    {}, {"warmup_steps": 10, "total_steps": 50, "lr": 1e-2},
    {"warmup_steps": 0, "total_steps": 1}])
def test_schedule_matches_reference(cfg):
    """At 1e-7 of the peak lr: the two libraries' float32 cos differ by up
    to one ulp, which ``1 + cos`` near the end of the decay carries into a
    few ulps of a small lr (the warmup branch is exact)."""
    t, j = adamw.AdamWConfig(**cfg), jadamw.AdamWConfig(**cfg)
    for step in (0, 1, 5, 9, 10, 11, 49, 99, 100, 101, 5000, 10000, 20000):
        got = adamw.schedule(t, step)
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(float(got),
                                   float(jadamw.schedule(j, step)),
                                   rtol=1e-7, atol=1e-7 * t.lr)


@pytest.mark.parametrize("clip", [1.0, 0.0])
def test_apply_updates_matches_reference(clip):
    """Two updates of a small float32 tree (the clip binds: the grads'
    norm is ~10), with an extra state slot, equal the reference's at
    1e-7."""
    t_cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=1, grad_clip=clip)
    j_cfg = jadamw.AdamWConfig(lr=1e-2, warmup_steps=1, grad_clip=clip)
    p_np = _small_tree(0)  # copied into each package: the port updates
    pt = jax.tree.map(lambda a: torch.from_numpy(a.copy()), p_np)
    pj = jax.tree.map(lambda a: jnp.array(a, copy=True), p_np)
    st, sj = adamw.init_state(pt), jadamw.init_state(pj)
    st["error_feedback"] = sj["error_feedback"] = "kept"
    for i in (1, 2):
        g_np = jax.tree.map(lambda a: a * 4, _small_tree(i))
        pt, st, mt = adamw.apply_updates(
            pt, jax.tree.map(torch.from_numpy, g_np), st, t_cfg)
        pj, sj, mj = jadamw.apply_updates(
            pj, jax.tree.map(jnp.asarray, g_np), sj, j_cfg)
        assert st["error_feedback"] == "kept" and int(st["count"]) == i
        assert st["count"].dtype == torch.int32
        for k in ("grad_norm", "lr"):
            assert mt[k].dim() == 0 and mt[k].dtype == torch.float32
            np.testing.assert_allclose(float(mt[k]), float(mj[k]),
                                       rtol=1e-7, atol=1e-7)
        for got, want in ((pt, pj), (st["mu"], sj["mu"]),
                          (st["nu"], sj["nu"])):
            _close(got, want, tol=1e-7, what=f"update {i}")


def test_apply_updates_keeps_bf16_params_in_place():
    p = {"w": torch.ones(4, dtype=torch.bfloat16, requires_grad=True)}
    w = p["w"]
    st = adamw.init_state(p)
    p2, st2, _ = adamw.apply_updates(p, {"w": torch.ones(4)}, st,
                                     adamw.AdamWConfig(lr=0.1,
                                                       warmup_steps=1))
    assert p2["w"] is w and w.dtype == torch.bfloat16 and w.requires_grad
    assert st2["mu"]["w"].dtype == torch.float32
    assert float(w.detach()[0]) < 1.0


def test_quantize_is_bit_equal():
    rng = np.random.default_rng(0)
    halves = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 3.5, 0.0],
                      np.float32)  # scale 1: round half to even
    for g in (halves, rng.standard_normal((64, 33)).astype(np.float32),
              np.zeros(5, np.float32), rng.uniform(-1e-3, 1e-3, 100)
              .astype(np.float32)):
        for bits in (8, 4):
            qt, st = grad_compression.quantize(torch.from_numpy(g), bits)
            qj, sj = jgc.quantize(jnp.asarray(g), bits)
            assert qt.dtype == torch.int8
            np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
            assert st.numpy().tobytes() == np.asarray(sj).tobytes()
            np.testing.assert_array_equal(
                grad_compression.dequantize(qt, st).numpy(),
                np.asarray(jgc.dequantize(qj, sj)))


def test_compress_decompress_is_bit_equal():
    """Two rounds with error feedback: grads and residuals bit-equal."""
    gt_state, gj_state = {}, {}
    for i in (0, 1):
        g_np = _small_tree(10 + i)
        gt, gt_state = grad_compression.compress_decompress(
            jax.tree.map(torch.from_numpy, g_np), gt_state)
        gj, gj_state = jgc.compress_decompress(
            jax.tree.map(jnp.asarray, g_np), gj_state)
        for a, b in zip(leaves(gt) + leaves(gt_state["error_feedback"]),
                        jax.tree.leaves(gj) + jax.tree.leaves(
                            gj_state["error_feedback"])):
            assert a.numpy().tobytes() == np.asarray(b).tobytes()


# ----------------------------------------------------------------------
# data pipeline
# ----------------------------------------------------------------------

@pytest.mark.parametrize("shard", [(0, 1), (1, 4), (3, 4)])
@pytest.mark.parametrize("seed", [0, 7])
def test_batch_for_step_is_bit_equal(shard, seed):
    for step in (0, 3, 1000):
        kw = dict(global_batch=8, seq=16, vocab=64, seed=seed, shard=shard)
        got, want = batch_for_step(step, **kw), j_batch_for_step(step, **kw)
        for k in ("tokens", "labels"):
            assert got[k].dtype == want[k].dtype == np.int32
            np.testing.assert_array_equal(got[k], want[k])


def test_dataset_state_round_trip_matches_reference():
    ds, jds = (cls(global_batch=4, seq=8, vocab=64, seed=3)
               for cls in (SyntheticLMDataset, JDataset))
    for _ in range(2):
        np.testing.assert_array_equal(next(ds)["tokens"],
                                      next(jds)["tokens"])
    state = ds.state_dict()
    assert state == jds.state_dict()
    b3 = next(ds)
    # the port's state restores the reference's dataset, and the reverse
    jds2 = JDataset(global_batch=4, seq=8, vocab=64, seed=3)
    jds2.load_state_dict(state)
    ds2 = SyntheticLMDataset(global_batch=4, seq=8, vocab=64, seed=3)
    ds2.load_state_dict(jds.state_dict())
    for other in (jds2, ds2):
        np.testing.assert_array_equal(b3["labels"], next(other)["labels"])


# ----------------------------------------------------------------------
# one train step against jax.value_and_grad + the reference's AdamW
# ----------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["olmo-1b", "rwkv6-1.6b", "zamba2-7b",
                                  "moonshot-v1-16b-a3b", "dbrx-132b",
                                  "seamless-m4t-medium"])
def test_train_step_matches_reference_float32(arch):
    """Every leaf of the gradients, the updated params and both moments.
    zamba2-7b: two groups of 2 Mamba-2 layers and a shared-block
    application each, each group rematerialised (full remat, as the
    reference's scans): the first gradient through the hybrid stack.
    The moe configs route through top-2 of 4 experts with capacity.
    seamless-m4t-medium: 2 encoder and 2 decoder layers, each
    rematerialised, on 32 frames; the gradient reaches the encoder through
    the cross K/V."""
    jc, tc_ = _cfgs(arch, "float32")
    pj = _j_params(arch, "float32")
    loss_j, grads_j = _j_value_and_grad(arch, "float32")
    pj2, sj2, mj = _j_apply(pj, grads_j, jadamw.init_state(pj), J_OPT)

    pt = _t_params(arch, "float32")
    step = make_train_step(tc_, TrainConfig(opt=OPT), device="cpu")
    # the gradients the step takes, captured on their way into AdamW
    seen = {}
    real = adamw.apply_updates

    def spy(params, grads, state, cfg):
        seen["grads"] = grads
        return real(params, grads, state, cfg)
    adamw.apply_updates = spy
    try:
        pt2, st2, m = step(pt, adamw.init_state(pt), _step_batch(jc))
    finally:
        adamw.apply_updates = real
    assert pt2 is pt and all(p.requires_grad for p in leaves(pt2))
    for k, want in (("loss", loss_j), ("grad_norm", mj["grad_norm"]),
                    ("lr", mj["lr"])):
        assert m[k].dim() == 0 and m[k].dtype == torch.float32
        np.testing.assert_allclose(float(m[k]), float(want), rtol=F32_TOL,
                                   atol=F32_TOL, err_msg=k)
    _close(seen["grads"], grads_j, what="grads")
    _close_params(pt2, pj2, sj2["mu"], float(mj["lr"]))
    _close(st2["mu"], sj2["mu"], what="mu")
    _close(st2["nu"], sj2["nu"], what="nu")
    assert int(st2["count"]) == 1


def test_train_step_bf16_loss_matches_reference():
    jc, tc_ = _cfgs("olmo-1b", "bfloat16")
    want = float(jax.jit(lambda p, b: JR.loss_fn(p, b, jc))(
        _j_params("olmo-1b", "bfloat16"),
        {k: jnp.asarray(v) for k, v in _batch(vocab=jc.vocab).items()}))
    pt = _t_params("olmo-1b", "bfloat16")
    before = [p.detach().clone() for p in leaves(pt)]
    _, st, m = make_train_step(tc_, TrainConfig(opt=OPT), device="cpu")(
        pt, adamw.init_state(pt), _batch(vocab=jc.vocab))
    assert abs(float(m["loss"]) - want) <= BF16_LOSS_TOL * abs(want)
    assert np.isfinite(float(m["grad_norm"]))
    assert all(p.dtype == torch.bfloat16 for p in leaves(pt))
    assert all(m_.dtype == torch.float32 for m_ in leaves(st["mu"]))
    assert any(not torch.equal(a, b) for a, b in zip(before, leaves(pt)))


def test_microbatches_match_reference_step():
    jc, tc_ = _cfgs("olmo-1b", "float32")
    b = _batch(b=8, vocab=jc.vocab)
    pj = _j_params("olmo-1b", "float32")
    jstep = jax.jit(j_make_train_step(jc, JTrainConfig(microbatches=4,
                                                       opt=J_OPT)))
    pj2, sj2, mj = jstep(pj, jadamw.init_state(pj),
                         {k: jnp.asarray(v) for k, v in b.items()})
    pt = _t_params("olmo-1b", "float32")
    pt2, st2, m = make_train_step(
        tc_, TrainConfig(microbatches=4, opt=OPT), device="cpu")(
        pt, adamw.init_state(pt), b)
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(m[k]), float(mj[k]), rtol=F32_TOL,
                                   atol=F32_TOL, err_msg=k)
    _close_params(pt2, pj2, sj2["mu"], float(mj["lr"]))
    _close(st2["mu"], sj2["mu"], what="mu")
    _close(st2["nu"], sj2["nu"], what="nu")


def test_compressed_step_matches_reference():
    """``compress_grads=True``: the reference compresses its gradients, the
    port its own, which differ by ~1e-7 relative; where a value of g / s
    (g the gradient plus its error feedback, s the leaf's scale) lies
    within 1e-4 of a rounding boundary (~1e-7 relative of values up to 127)
    the two sides may round to neighbouring levels, one quantum apart, so
    those elements (counted: 0.02% expected, at most 0.1%) are left out of
    the 1e-5 comparison of the compressed step's error feedback, moments
    and params."""
    jc, tc_ = _cfgs("olmo-1b", "float32")
    pj = _j_params("olmo-1b", "float32")
    loss_j, grads_j = _j_value_and_grad("olmo-1b", "float32")
    ef0 = jax.tree.map(lambda a: jnp.full(a.shape, 1e-3, jnp.float32), pj)
    cj, sj = jgc.compress_decompress(
        grads_j, {**jadamw.init_state(pj), "error_feedback": ef0})
    pj2, sj2, mj = _j_apply(pj, cj, sj, J_OPT)

    pt = _t_params("olmo-1b", "float32")
    st = adamw.init_state(pt)
    st["error_feedback"] = jax.tree.map(
        lambda a: torch.full(a.shape, 1e-3), ef0)
    pt2, st2, m = make_train_step(
        tc_, TrainConfig(compress_grads=True, opt=OPT), device="cpu")(
        pt, st, _batch(vocab=jc.vocab))
    np.testing.assert_allclose(float(m["loss"]), float(loss_j),
                               rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(float(m["grad_norm"]), float(mj["grad_norm"]),
                               rtol=F32_TOL, atol=F32_TOL)
    n_edge = n_all = 0
    for g, e0, trees in zip(
            jax.tree.leaves(grads_j), jax.tree.leaves(ef0),
            zip(*(zip(leaves(a), jax.tree.leaves(b)) for a, b in (
                (st2["error_feedback"], sj2["error_feedback"]),
                (st2["mu"], sj2["mu"]), (st2["nu"], sj2["nu"]),
                (pt2, pj2))))):
        gf = np.asarray(g) + np.asarray(e0)
        scale = max(float(np.abs(gf).max()) / 127.0, 1e-12)
        edge = np.abs(np.abs(gf / scale) % 1.0 - 0.5) < 1e-4
        n_edge, n_all = n_edge + int(edge.sum()), n_all + edge.size
        for a, b in trees:
            np.testing.assert_allclose(_np(a)[~edge], _np(b)[~edge],
                                       rtol=F32_TOL, atol=F32_TOL)
    assert n_edge <= 1e-3 * n_all, (n_edge, n_all)
    assert any(float(e.abs().sum()) > 0 for e in
               leaves(st2["error_feedback"]))


# ----------------------------------------------------------------------
# the port on its own: tests/test_training.py's counterparts
# ----------------------------------------------------------------------

def _fresh(tc=TrainConfig()):
    _, tc_ = _cfgs("olmo-1b", "bfloat16")
    return tc_, init_train_state(tc_, tc, 0, "cpu")


def test_loss_decreases_over_training():
    tc = TrainConfig(opt=adamw.AdamWConfig(lr=3e-3, warmup_steps=5,
                                           total_steps=60))
    cfg, (params, opt) = _fresh(tc)
    step = make_train_step(cfg, tc, device="cpu")
    losses = []
    for i in range(40):
        params, opt, m = step(params, opt, _batch(i, b=8))
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) * 0.9


def test_grad_compression_trains():
    tc = TrainConfig(compress_grads=True,
                     opt=adamw.AdamWConfig(lr=3e-3, warmup_steps=5,
                                           total_steps=60))
    cfg, (params, opt) = _fresh(tc)
    assert "error_feedback" in opt
    step = make_train_step(cfg, tc, device="cpu")
    losses = []
    for i in range(30):
        params, opt, m = step(params, opt, _batch(i, b=8))
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) * 0.95
    assert sum(float(e.abs().sum())
               for e in leaves(opt["error_feedback"])) > 0


# ----------------------------------------------------------------------
# checkpoints, restart, stragglers
# ----------------------------------------------------------------------

def _bits(x) -> bytes:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.view(torch.int16) if x.dtype == torch.bfloat16
                else x).numpy().tobytes()
    a = np.asarray(x)
    return (a.view(np.uint16) if a.dtype.name == "bfloat16" else a
            ).tobytes()


def _same_bits(a_tree, b_tree):
    a, b = leaves(a_tree), jax.tree.leaves(b_tree)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert tuple(x.shape) == tuple(np.shape(y)) and _bits(x) == _bits(y)


def test_checkpoint_roundtrip(tmp_path):
    _, (params, opt) = _fresh()
    ck = Checkpointer(str(tmp_path), keep=2)
    ck.save(3, (params, opt), extra={"note": 1})
    restored, manifest = ck.restore((params, opt), device="cpu")
    assert manifest["step"] == 3 and manifest["extra"] == {"note": 1}
    for a, b in zip(leaves((params, opt)), leaves(restored)):
        assert a.dtype == b.dtype and b.device == CPU
        assert torch.equal(a.detach(), b)


def test_checkpoint_retention_and_async(tmp_path):
    _, (params, _) = _fresh()
    ck = Checkpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        if s == 3:
            at_3 = [p.detach().clone() for p in leaves(params)]
        ck.save(s, params, async_save=True)
        with torch.no_grad():  # the save copied first: updates are free
            for p in leaves(params):
                p.add_(1)
    ck.wait()
    assert ck.all_steps() == [3, 4]
    restored, _ = ck.restore(params, step=3, device="cpu")
    for a, b in zip(at_3, leaves(restored)):
        assert torch.equal(a, b)


def test_checkpoints_cross_between_packages(tmp_path):
    """A JAX checkpoint (bf16 params, float32 moments, int32 count)
    restores bit-equal in the port, and the port's in the JAX package."""
    jc, _ = _cfgs("olmo-1b", "bfloat16")
    pj = _j_params("olmo-1b", "bfloat16")
    sj = jadamw.init_state(pj)
    sj["mu"] = jax.tree.map(lambda a: a + 0.5, sj["mu"])
    JCheckpointer(str(tmp_path / "j"), keep=1).save(5, (pj, sj))
    pt = _t_params("olmo-1b", "bfloat16")
    st = adamw.init_state(pt)
    restored, manifest = Checkpointer(str(tmp_path / "j")).restore(
        (pt, st), device="cpu")
    assert manifest["step"] == 5
    assert any(t.dtype == torch.bfloat16 for t in leaves(restored))
    _same_bits(restored, (pj, sj))

    with torch.no_grad():
        for p in leaves(pt):
            p.mul_(3)
    Checkpointer(str(tmp_path / "t"), keep=1).save(6, (pt, st))
    back, manifest = JCheckpointer(str(tmp_path / "t")).restore((pj, sj))
    assert manifest["step"] == 6
    _same_bits((pt, st), back)


def test_restore_raises_without_checkpoint(tmp_path):
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path)).restore({}, device="cpu")


def test_restart_resumes_identically(tmp_path):
    """A crash at step 5 restores step 4's checkpoint and replays: the
    state equals the uninterrupted run's."""
    tc = TrainConfig(opt=adamw.AdamWConfig(lr=1e-3, warmup_steps=2,
                                           total_steps=50))
    cfg, _ = _fresh()
    step = make_train_step(cfg, tc, device="cpu")

    def wrapped(state, b):
        p, o = state
        p, o, m = step(p, o, b)
        return (p, o), m

    ft = FTConfig(checkpoint_every=2, async_save=False)
    loop_a = FaultTolerantLoop(wrapped, Checkpointer(str(tmp_path / "a"),
                                                     keep=5), ft)
    state_a, end_a = loop_a.run(_fresh()[1], _batch, 0, 8)
    crashed = []

    def injector(s):
        if s == 5 and not crashed:
            crashed.append(s)
            raise RuntimeError("injected worker failure")

    loop_b = FaultTolerantLoop(wrapped, Checkpointer(str(tmp_path / "b"),
                                                     keep=5), ft,
                               fault_injector=injector)
    state_b, end_b = loop_b.run(_fresh()[1], _batch, 0, 8)
    assert loop_b.restarts == 1 and end_a == end_b == 8
    assert [e.step for e in loop_b.events if e.restarted] == [4]
    for a, b in zip(leaves(state_a), leaves(state_b)):
        assert torch.equal(a.detach(), b.detach())


def test_straggler_watchdog(tmp_path, monkeypatch):
    """Step walls from a stepped clock: 0.01 s each, 0.3 s for the sixth
    (step 5), flagged against a 5x threshold."""
    now = [0.0]
    monkeypatch.setattr(coordinator, "time", types.SimpleNamespace(
        perf_counter=lambda: now[0]))
    calls = []

    def slow_step(state, b):
        calls.append(b)
        now[0] += 0.3 if len(calls) == 6 else 0.01
        return state, {"loss": torch.zeros(())}

    flagged = []
    loop = FaultTolerantLoop(
        slow_step, Checkpointer(str(tmp_path), keep=1),
        FTConfig(checkpoint_every=1000, straggler_threshold=5.0),
        on_straggler=lambda ev: flagged.append(ev.step))
    loop.run((), lambda i: None, 0, 10)
    assert loop.straggler_steps == [5] and flagged == [5]
    assert [round(e.wall_s, 6) for e in loop.events][4:7] == [0.01, 0.3,
                                                             0.01]


def test_train_cli_on_cpu(tmp_path, capsys):
    args = ["--device", "cpu", "--steps", "3", "--batch", "2", "--seq",
            "32", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    assert train_cli.main(args) == 0
    out = capsys.readouterr().out
    assert "done: 3 steps" in out and "final loss" in out
    assert Checkpointer(str(tmp_path)).all_steps() == [2]
    assert train_cli.main(args + ["--resume"]) == 0
    assert "resumed from step 2" in capsys.readouterr().out


# the train CLI's resume, as the reference's: its state is params and
# AdamW's moments (no error feedback); --compress-grads starts the feedback
# at zero on its first step, also after a resume, and a saved feedback is
# dropped on restore (ROADMAP §3, kept on purpose)
CLI_ARGS = ["--device", "cpu", "--arch", "olmo-1b", "--batch", "2", "--seq",
            "16", "--ckpt-every", "1", "--lr", "3e-3", "--steps", "2"]


def _cli_loss(argv, capsys) -> float:
    assert train_cli.main(argv) == 0
    out = capsys.readouterr().out
    return float(out.split("final loss ")[1].split(",")[0])


def _cli_by_library(segments, drop_feedback: bool = True) -> float:
    """The CLI's runs as library calls on the same batches: params from
    seed 0, ``adamw.init_state``, then each (steps, compress) segment from
    where the last one ended, with the error feedback dropped at the
    break where ``drop_feedback``; the final loss on the next batch."""
    from repro_torch.models import registry
    from repro_torch.models.param import init_params
    cfg = REGISTRY["olmo-1b"].reduced()
    params = init_params(registry.specs(cfg), 0, "cpu")
    opt = adamw.init_state(params)
    step = 0
    for n, compress in segments:
        tc = TrainConfig(compress_grads=compress, opt=adamw.AdamWConfig(
            lr=3e-3, warmup_steps=10, total_steps=n))
        fn = make_train_step(cfg, tc, device="cpu")
        if drop_feedback:
            opt = {k: v for k, v in opt.items() if k != "error_feedback"}
        for i in range(step, step + n):
            params, opt, _ = fn(params, opt, batch_for_step(
                i, global_batch=2, seq=16, vocab=cfg.vocab))
        step += n
    with torch.no_grad():
        return float(registry.loss_fn(params, batch_for_step(
            step, global_batch=2, seq=16, vocab=cfg.vocab), cfg,
            device="cpu"))


# the CLI prints the loss to 4 decimals; the library runs the same steps
PRINTED = 1e-4


@pytest.mark.parametrize("saved_compressed", [False, True],
                         ids=["a-saved-plain", "b-saved-compressed"])
def test_train_cli_resumes_into_compression(tmp_path, capsys,
                                            saved_compressed):
    """(a) a checkpoint saved without ``--compress-grads`` resumes with it;
    (b) one saved with it resumes with it, dropping the saved feedback as
    the reference's CLI does.  Each against the same steps taken through
    the library (the two packages draw other weights)."""
    first = ["--compress-grads"] if saved_compressed else []
    _cli_loss(CLI_ARGS + ["--ckpt-dir", str(tmp_path)] + first, capsys)
    got = _cli_loss(CLI_ARGS + ["--ckpt-dir", str(tmp_path), "--resume",
                                "--compress-grads"], capsys)
    segments = [(2, saved_compressed), (2, True)]
    assert abs(got - _cli_by_library(segments)) <= PRINTED
    if saved_compressed:  # keeping the feedback would give another loss
        assert abs(got - _cli_by_library(segments, drop_feedback=False)) \
            > 100 * PRINTED


def test_restore_refuses_a_format_it_does_not_read(tmp_path):
    """A leaf whose stored dtype is not its logical one (the reference's
    float8 views) raises instead of loading as raw bits."""
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"w": torch.ones(3, dtype=torch.uint8)})
    manifest = tmp_path / "step_000000001" / "manifest.json"
    manifest.write_text(manifest.read_text().replace('"uint8"',
                                                     '"float8_e4m3fn"'))
    with pytest.raises(ValueError, match="float8_e4m3fn"):
        ck.restore({"w": None}, device="cpu")
