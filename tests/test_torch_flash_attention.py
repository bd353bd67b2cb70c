"""Port of the flash attention kernel module against the JAX package's: the
plain PyTorch ``attention_ref`` against the Pallas kernel (interpret mode)
and the JAX ``attention_ref`` on the shapes of ``tests/test_kernels.py``,
``ops.attention`` on CPU tensors, and the wrapper's input checks.  The CUDA
kernel itself runs only on the card (``tests/test_torch_cuda.py``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import attention_ref as j_ref  # noqa: E402
from repro.kernels.flash_attention import \
    flash_attention as j_flash  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    attention, attention_ref, flash_attention)

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
    _, (q, k, v) = _both(_inputs(1, 128, 128, 2, 2, 16), "float32")
    q.requires_grad_(True)
    with pytest.raises(RuntimeError, match="backward"):
        flash_attention(q, k, v)
    with torch.no_grad():
        out = flash_attention(q, k, v)
    assert not out.requires_grad
    torch.testing.assert_close(out, attention_ref(q.detach(), k, v),
                               rtol=0, atol=0)
