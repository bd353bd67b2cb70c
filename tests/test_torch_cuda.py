"""The port on the card: the maestro_eval CUDA kernel against its plain
PyTorch version, its launch count and input checks, and the default
device.  Imports no JAX, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

Without a CUDA device every test here skips (the kernel has no CPU mode).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import dnn_models, tensor_analysis  # noqa: E402
from repro_torch.core.dataflows import table3_for_layer  # noqa: E402
from repro_torch.core.dse import DSEConfig, run_dse  # noqa: E402
from repro_torch.devices import resolve_device  # noqa: E402
from repro_torch.kernels.maestro_eval import (  # noqa: E402
    build_tables, closed_form_features, dse_eval, maestro_eval)

pytestmark = pytest.mark.gpu

OPS = {
    "late": tensor_analysis.conv2d("late", k=128, c=96, y=14, x=14, r=3,
                                   s=3),
    "fc": tensor_analysis.fc("fc", k=512, c=1024),
    "early": tensor_analysis.conv2d("early", k=64, c=3, y=112, x=112, r=7,
                                    s=7, stride=2),
}
CASES = [(name, flow) for name in OPS for flow in ("C-P", "X-P")]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _tables(name, flow):
    op = OPS[name]
    return build_tables(op, table3_for_layer(flow, op))


def _designs(seed, device):
    rng = np.random.default_rng(seed)
    pes = np.concatenate([np.arange(1, 65), rng.integers(65, 16385, 4000)])
    bw = rng.uniform(1, 1024, len(pes))
    bw[::9] = np.round(bw[::9])
    return (torch.from_numpy(pes.astype(np.int32)).to(device),
            torch.from_numpy(bw.astype(np.float32)).to(device))


@pytest.mark.parametrize("case", CASES, ids="-".join)
def test_kernel_matches_plain(cuda, case):
    T = _tables(*case)
    p, b = _designs(3, cuda)
    got = maestro_eval(p, b, tables=T)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, closed_form_features(p, b, T),
                               rtol=1e-6, atol=0)


def test_kernel_on_every_vgg16_table(cuda):
    p, b = _designs(5, cuda)
    for op in dnn_models.vgg16():
        for flow in ("C-P", "X-P"):
            T = build_tables(op, table3_for_layer(flow, op))
            torch.testing.assert_close(maestro_eval(p, b, tables=T),
                                       closed_form_features(p, b, T),
                                       rtol=1e-6, atol=0)


def test_dse_eval_counts_launches(cuda):
    T = _tables("late", "X-P")
    before = maestro_eval.launches
    p, b = _designs(4, cuda)
    out = dse_eval(p, b, tables=T)
    assert out.is_cuda and maestro_eval.launches == before + 1
    dse_eval(p.cpu(), b.cpu(), tables=T)  # the plain path launches nothing
    assert maestro_eval.launches == before + 1
    with pytest.raises(ValueError, match="device"):
        dse_eval(p, b, tables=T, device="cpu")
    assert maestro_eval.launches == before + 1


def test_kernel_rejects_bad_inputs(cuda):
    T = _tables("late", "C-P")
    p = torch.ones(8, dtype=torch.int32, device=cuda)
    b = torch.ones(8, device=cuda)
    with pytest.raises(TypeError):
        maestro_eval(p.long(), b, tables=T)
    with pytest.raises(ValueError):
        maestro_eval(p[::2], b[::2], tables=T)
    with pytest.raises(ValueError):
        maestro_eval(p, b[:4], tables=T)
    with pytest.raises(ValueError):
        maestro_eval(p, b.cpu(), tables=T)
    assert maestro_eval(p[:0], b[:0], tables=T).shape == (0, 5)


def test_default_device_is_cuda(cuda):
    assert resolve_device().type == "cuda"
    op = dnn_models.vgg16()[10]
    cfg = DSEConfig(pe_range=(8, 16), bw_range=(1.0, 2.0))
    r = run_dse(op, table3_for_layer("C-P", op), cfg)
    ref = run_dse(op, table3_for_layer("C-P", op), cfg, device="cpu")
    np.testing.assert_array_equal(r.stats.runtime, ref.stats.runtime)
    np.testing.assert_allclose(r.stats.energy_pj, ref.stats.energy_pj,
                               rtol=1e-6)
