"""Rules of the port: ``repro_torch`` imports neither JAX nor ``repro``;
its entry points run on CUDA unless the caller asks for the CPU, and
without a CUDA device they raise instead of falling back."""
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import REGISTRY  # noqa: E402
from repro_torch.core import dnn_models as tdm  # noqa: E402
from repro_torch.core.dse import DSEConfig, run_dse, \
    run_dse_full  # noqa: E402
from repro_torch.core.dataflows import table3_for_layer  # noqa: E402
from repro_torch.core.vectorized import (  # noqa: E402
    batched_evaluator, batched_tile_evaluator)
from repro_torch import mapspace  # noqa: E402
from repro_torch.devices import resolve_device  # noqa: E402
from repro_torch.inference import ServeEngine  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    attention, flash_attention)
from repro_torch.kernels.linear_scan import linear_scan, scan_op  # noqa: E402
from repro_torch.kernels.maestro_eval import dse_eval  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.models.param import init_params  # noqa: E402

SRC = Path(repro_torch.__file__).resolve().parents[1]
MODULES = sorted(m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, prefix="repro_torch."))


def test_every_module_is_listed():
    for name in ("repro_torch.core.dse", "repro_torch.core.vectorized",
                 "repro_torch.kernels.maestro_eval.ops",
                 "repro_torch.kernels._build",
                 "repro_torch.kernels.flash_attention.ops",
                 "repro_torch.kernels.linear_scan.linear_scan",
                 "repro_torch.kernels.linear_scan.ops",
                 "repro_torch.kernels.linear_scan.ref",
                 "repro_torch.models.ssm",
                 "repro_torch.configs.llama3_8b",
                 "repro_torch.models.layers", "repro_torch.models.transformer",
                 "repro_torch.models.registry",
                 "repro_torch.inference.engine",
                 "repro_torch.launch.llmserve",
                 "repro_torch.interop", "repro_torch.resilience.errors",
                 "repro_torch.resilience.policy",
                 "repro_torch.resilience.watchdog",
                 "repro_torch.resilience.sweepckpt",
                 "repro_torch.resilience.faultinject",
                 "repro_torch.obs.context", "repro_torch.obs.metrics",
                 "repro_torch.obs.trace", "repro_torch.mapspace.space",
                 "repro_torch.mapspace.universal",
                 "repro_torch.mapspace.batched",
                 "repro_torch.mapspace.cache",
                 "repro_torch.mapspace.search",
                 "repro_torch.mapspace.codse", "repro_torch.obs.env",
                 "repro_torch.api.spec", "repro_torch.api.report",
                 "repro_torch.api.session", "repro_torch.launch.query",
                 "repro_torch.launch.mapsearch",
                 "repro_torch.netspace.space",
                 "repro_torch.netspace.composer",
                 "repro_torch.netspace.evaluator",
                 "repro_torch.netspace.search",
                 "repro_torch.serve.coalescer",
                 "repro_torch.launch.netsearch",
                 "repro_torch.obs.prom", "repro_torch.obs.flightrec",
                 "repro_torch.obs.profile",
                 "repro_torch.analysis.findings",
                 "repro_torch.analysis.speclint",
                 "repro_torch.serve.deadline",
                 "repro_torch.serve.admission",
                 "repro_torch.serve.drain", "repro_torch.serve.loadgen",
                 "repro_torch.serve.server", "repro_torch.launch.serve",
                 "repro_torch.launch.loadgen", *TRAINING_MODULES,
                 "repro_torch.kernels.flash_attention.ref",
                 "repro_torch.tree"):
        assert name in MODULES


TRAINING_MODULES = ("repro_torch.optim", "repro_torch.optim.adamw",
                    "repro_torch.training", "repro_torch.training.train_step",
                    "repro_torch.training.grad_compression",
                    "repro_torch.data", "repro_torch.data.pipeline",
                    "repro_torch.checkpoint",
                    "repro_torch.checkpoint.checkpointer",
                    "repro_torch.ft", "repro_torch.ft.coordinator",
                    "repro_torch.launch.train")


def test_training_modules_load_no_jax_no_repro_no_ml_dtypes():
    """The training slice alone: its checkpoints keep the reference's
    bfloat16 format without ``ml_dtypes``."""
    code = (
        "import importlib, sys\n"
        f"for m in {TRAINING_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro', 'ml_dtypes'))\n"
        "print(repr(bad))\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr


def test_importing_the_port_loads_no_jax_and_no_repro():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'jaxlib' or m == 'repro' or "
        "m.startswith('repro.'))\n"
        "print(repr(bad))\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr


def test_port_sources_never_name_jax_imports():
    for path in (SRC / "repro_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            s = line.strip()
            assert not s.startswith(("import jax", "from jax")), path
            assert not s.startswith(("import repro.", "from repro.",
                                     "from repro import")), path


@pytest.fixture
def no_cuda(monkeypatch):
    """A CPU-only machine, whatever this one has."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _small():
    op = tdm.vgg16()[10]
    return op, DSEConfig(pe_range=(8, 16), bw_range=(1.0, 2.0))


def test_run_dse_without_device_raises_on_cpu_only_machine(no_cuda):
    op, cfg = _small()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_dse(op, table3_for_layer("C-P", op), cfg)
    with pytest.raises(RuntimeError):
        run_dse_full(op, "KC-P", cfg, scales=(1,))


def test_other_entry_points_raise_without_device(no_cuda):
    op, _ = _small()
    df = table3_for_layer("C-P", op)
    with pytest.raises(RuntimeError):
        batched_evaluator(op, df)
    with pytest.raises(RuntimeError):
        dse_eval([8, 16], [1.0, 2.0], op=op, dataflow=df)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")


def test_cpu_on_request(no_cuda):
    op, cfg = _small()
    r = run_dse(op, table3_for_layer("C-P", op), cfg, device="cpu")
    assert r.n_evaluated == 4
    assert resolve_device("cpu") == torch.device("cpu")


def _llm():
    cfg = REGISTRY["llama3-8b"].reduced().replace(n_kv_heads=2)
    return cfg, init_params(registry.specs(cfg), 0, "cpu")


def test_llm_entry_points_raise_without_device(no_cuda):
    cfg, params = _llm()
    toks = np.zeros((1, 8), np.int32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(registry.specs(cfg), 0)
    with pytest.raises(RuntimeError):
        registry.loss_fn(params, {"tokens": toks, "labels": toks}, cfg)
    with pytest.raises(RuntimeError):
        registry.prefill(params, {"tokens": toks}, cfg, 16)
    with pytest.raises(RuntimeError):
        ServeEngine(cfg, params)
    q = np.zeros((1, 128, 2, 16), np.float32)
    with pytest.raises(RuntimeError):
        attention(q, q, q)
    with pytest.raises(RuntimeError):
        interop.params_from_jax({"w": q})


def test_llm_entry_points_run_on_cpu_on_request(no_cuda):
    cfg, params = _llm()
    toks = np.zeros((1, 8), np.int32)
    loss = registry.loss_fn(params, {"tokens": toks, "labels": toks}, cfg,
                            device="cpu")
    assert np.isfinite(float(loss))
    logits, cache = registry.prefill(params, {"tokens": toks}, cfg, 16,
                                     device="cpu")
    logits, _ = registry.decode_step(params, {"tokens": toks[:, :1]}, cache,
                                     cfg, device="cpu")
    assert logits.shape == (1, 1, cfg.padded_vocab)
    eng = ServeEngine(cfg, params, slots=1, max_len=16, device="cpu")
    eng.submit(toks[0], max_new=2)
    assert len(eng.run()[0].generated) == 2
    q = torch.zeros(1, 128, 2, 16)
    assert attention(q, q, q).device.type == "cpu"
    assert flash_attention(q, q, q).device.type == "cpu"
    with pytest.raises(ValueError, match="asked for"):
        registry.loss_fn(params, {"tokens": torch.from_numpy(toks),
                                  "labels": toks}, cfg, device="cuda")


def _rwkv():
    cfg = REGISTRY["rwkv6-1.6b"].reduced()
    return cfg, init_params(registry.specs(cfg), 0, "cpu")


def test_rwkv_entry_points_raise_without_device(no_cuda):
    cfg, params = _rwkv()
    toks = np.zeros((1, 8), np.int32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        registry.loss_fn(params, {"tokens": toks, "labels": toks}, cfg)
    with pytest.raises(RuntimeError):
        registry.prefill(params, {"tokens": toks}, cfg, 16)
    with pytest.raises(RuntimeError):
        ServeEngine(cfg, params)


def test_rwkv_entry_points_run_on_cpu_on_request(no_cuda):
    cfg, params = _rwkv()
    toks = np.zeros((1, 8), np.int32)
    loss = registry.loss_fn(params, {"tokens": toks, "labels": toks}, cfg,
                            device="cpu")
    assert np.isfinite(float(loss))
    logits, cache = registry.prefill(params, {"tokens": toks}, cfg, 16,
                                     device="cpu")
    assert all(t.device.type == "cpu" for t in cache[0]) and \
        cache[1].device.type == "cpu"
    logits, _ = registry.decode_step(params, {"tokens": toks[:, :1]}, cache,
                                     cfg, device="cpu")
    assert logits.shape == (1, 1, cfg.padded_vocab)
    eng = ServeEngine(cfg, params, slots=1, max_len=16, device="cpu")
    eng.submit(toks[0], max_new=2)
    assert len(eng.run()[0].generated) == 2
    x = torch.zeros(1, 16, 2, 8)
    o, s = scan_op(x, x, x, x, chunk=8)
    assert o.device.type == s.device.type == "cpu"
    assert linear_scan(x, x, x, x)[0].device.type == "cpu"
    with pytest.raises(ValueError, match="asked for"):
        registry.prefill(params, {"tokens": torch.from_numpy(toks)}, cfg,
                         16, device="cuda")


def _map_case():
    op = tdm.vgg16()[12]
    space = mapspace.build_space(op, dims=("K", "C"), cluster=False)
    return op, space


def test_mapping_search_raises_without_device(no_cuda):
    op, space = _map_case()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mapspace.search(op, space=space, budget=16)
    with pytest.raises(RuntimeError):
        mapspace.search_impl(op, space=space, budget=16, pipeline="legacy")
    g = mapspace.enumerate_genes(space)[:8]
    with pytest.raises(RuntimeError):
        mapspace.evaluate_genes(op, space, g, num_pes=256, noc_bw=32.0)
    with pytest.raises(RuntimeError):
        mapspace.evaluate_points(op, space, mapspace.points_from_genes(g),
                                 num_pes=256, noc_bw=32.0)
    key = tuple(int(x) for x in g[0, :3])
    tpl, slots = mapspace.group_template(space, key)
    with pytest.raises(RuntimeError):
        batched_tile_evaluator(op, tpl, slots, num_pes=256, noc_bw=32.0)


def test_mapping_search_runs_on_cpu_on_request(no_cuda):
    op, space = _map_case()
    r = mapspace.search(op, space=space, budget=16, strategy="random",
                        device="cpu", devices=4)
    assert r.n_evaluated == 16 and r.n_devices == 1
    assert np.isfinite(r.best_value)
    ev = mapspace.evaluate_genes(op, space, mapspace.enumerate_genes(space)[:8],
                                 num_pes=256, noc_bw=32.0, device="cpu")
    assert ev.run.n_devices == 1 and len(ev.top) == 8


def _front_door_case():
    from repro_torch.api import Hardware, Query, SearchSpec, Workload
    op, space = _map_case()
    q = Query(Workload.of_layer(op), Hardware(),
              SearchSpec(budget=16, dims=("K", "C"), cluster=False))
    grid = Query(q.workload, Hardware(pe_range=(8, 16), bw_range=(1.0,)),
                 q.search)
    return op, q, grid


def test_front_door_raises_without_device(no_cuda):
    from repro_torch.api import Session
    from repro_torch.launch import mapsearch
    op, q, grid = _front_door_case()
    for query in (q, grid):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Session().run(query)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mapspace.co_search(op, mapping_budget=16,
                           cfg=DSEConfig(pe_range=(8,), bw_range=(1.0,)))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mapsearch.main(["--model", "vgg16", "--layer", "12",
                        "--budget", "16", "--cache-dir", ""])


def test_front_door_runs_on_cpu_on_request(no_cuda, capsys):
    from repro_torch.api import Session
    from repro_torch.launch import mapsearch
    op, q, grid = _front_door_case()
    s = Session(device="cpu")
    assert np.isfinite(s.run(q).best["value"])
    assert s.run(grid).best["per_objective"]["edp"] is not None
    co = mapspace.co_search(op, mapping_budget=16, device="cpu",
                            cfg=DSEConfig(pe_range=(8,), bw_range=(1.0,)))
    assert co.n_evaluated == 16 + len(co.dse)
    mapsearch.main(["--model", "vgg16", "--layer", "12", "--budget", "16",
                    "--cache-dir", "", "--device", "cpu"])
    assert "best edp = " in capsys.readouterr().out


def _net_case():
    from repro_torch.api import Hardware, Query, SearchSpec, Workload
    layers = [tdm.vgg16()[12], tdm.vgg16()[13]]
    spec = SearchSpec(budget=16, frontier_k=2, block=64)
    net = Query(Workload.of_layers(layers), Hardware(), spec)
    batch = [Query(Workload.of_layer(op), Hardware(), spec)
             for op in layers]
    return layers, net, batch


def test_network_search_raises_without_device(no_cuda):
    from repro_torch import netspace
    from repro_torch.api import Session
    from repro_torch.launch import netsearch
    layers, net, batch = _net_case()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        netspace.search_network(layers, budget=16, frontier_k=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        netspace.co_search_network(layers, DSEConfig(pe_range=(8,),
                                                     bw_range=(1.0,)),
                                   budget=16, frontier_k=2)
    ns = netspace.build_netspace(layers)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        netspace.evaluate_candidates(
            ns, [mapspace.enumerate_genes(sp)[:4] for sp in ns.spaces],
            num_pes=256, noc_bw=32.0)
    s = Session()
    for call in (lambda: s.run(net), lambda: s.run_many(batch),
                 lambda: s.run_many([net])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    s.submit(batch[0])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        s.flush()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        netsearch.main(["--model", "alexnet", "--budget", "16",
                        "--frontier-k", "2"])


def test_network_search_runs_on_cpu_on_request(no_cuda, capsys):
    from repro_torch import netspace
    from repro_torch.api import Session
    from repro_torch.launch import netsearch
    layers, net, batch = _net_case()
    r = netspace.search_network(layers, budget=16, frontier_k=2,
                                device="cpu")
    assert r.n_devices == 1 and np.isfinite(r.network_edp)
    s = Session(device="cpu")
    assert s.run(net).kind == "network"
    reps = s.run_many(batch)
    assert [r.kind for r in reps] == ["layer", "layer"]
    assert all(r.coalesced for r in reps)
    netsearch.main(["--model", "alexnet", "--budget", "16",
                    "--frontier-k", "2", "--device", "cpu"])
    assert "# schedule vs best uniform" in capsys.readouterr().out


def test_server_raises_without_device(no_cuda, tmp_path):
    import asyncio
    from repro_torch.api import Session
    from repro_torch.launch import serve
    from repro_torch.serve import DSEServer, ServeConfig
    cfg = ServeConfig(port=0, exit_on_kill=False,
                      flight_dir=str(tmp_path))
    # at construction, before anything is admitted
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DSEServer(Session(cache_dir=None), cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--port", "0", "--cache-dir", "", "--flight-dir",
                    str(tmp_path)])

    # on the CPU on request: it starts, answers, and stops
    async def run():
        srv = DSEServer(Session(cache_dir=None, device="cpu"), cfg)
        await srv.start()
        try:
            from repro_torch.serve import http_json
            op = {"type": "conv2d", "name": "pr-s", "k": 8, "c": 6,
                  "y": 10, "x": 10, "r": 3, "s": 3}
            return await asyncio.wait_for(http_json(
                "127.0.0.1", srv.port, "POST", "/query",
                {"workload": {"op": op},
                 "search": {"objective": "edp", "budget": 16,
                            "block": 64}}), timeout=60)
        finally:
            await srv.stop()
    st, body = asyncio.run(run())
    assert st == 200 and body["kind"] == "layer"


def _train_case():
    from repro_torch.training import TrainConfig
    cfg = REGISTRY["olmo-1b"].reduced()
    toks = np.zeros((2, 8), np.int32)
    return cfg, TrainConfig(), {"tokens": toks, "labels": toks}


def test_training_raises_without_device(no_cuda, tmp_path):
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.launch import train
    from repro_torch.training import init_train_state, make_train_step
    cfg, tc, _ = _train_case()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_train_step(cfg, tc)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_train_state(cfg, tc, 0)
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"w": torch.ones(2)})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ck.restore({"w": None})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--steps", "1", "--ckpt-dir", str(tmp_path / "t")])


def test_training_runs_on_cpu_on_request(no_cuda, tmp_path, capsys):
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.launch import train
    from repro_torch.training import init_train_state, make_train_step
    cfg, tc, batch = _train_case()
    params, opt = init_train_state(cfg, tc, 0, "cpu")
    params, opt, m = make_train_step(cfg, tc, device="cpu")(params, opt,
                                                            batch)
    assert np.isfinite(float(m["loss"])) and int(opt["count"]) == 1
    ck = Checkpointer(str(tmp_path))
    ck.save(1, (params, opt))
    (p2, _), _ = ck.restore((params, opt), device="cpu")
    assert p2["embed"]["tok"].device.type == "cpu"
    train.main(["--steps", "1", "--batch", "2", "--seq", "16", "--device",
                "cpu", "--ckpt-dir", str(tmp_path / "t")])
    assert "done: 1 steps" in capsys.readouterr().out
