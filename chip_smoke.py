#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit code and no result):

1. require CUDA; print the card's name and power limit; build the
   ``maestro_eval``, ``flash_attention`` (forward and backward, two
   libraries) and ``linear_scan`` kernels from their sources under
   ``src/repro_torch/kernels/*/csrc`` (one ``nvcc`` each, all at once)
   and print the build seconds and ptxas registers and spills;
   ``cuobjdump -sass`` of the flash forward library and of the flash
   backward library must each show HGMMA (wgmma on the tensor cores) and
   UTMALDG (TMA loads);
2. the kernel against its plain PyTorch version on the card, for all 32
   VGG16 × {C-P, X-P} tables: pes 1..16384 × bw {1, 2, 3.5, 8, 64, 128} plus
   4096 random designs each, rtol 1e-6 on all five columns; runtime and macs
   against the port's batched evaluator and util against the port's
   faithful engine (``tests/test_kernels.py``'s tolerances);
3. the main path: ``run_dse_full`` on the card for vgg16-conv2 and
   vgg16-conv11 × {KC-P, YR-P} at the default ``DSEConfig`` grid with tile
   scales (1, 2, 4, 8), checked against the faithful engine and the §5.2
   invariant; then one ``run_dse`` call under ``torch.profiler`` for the
   card's busy and idle time;
4. paper scale: 32 tables × pes 1..16384 × bw 1..1024 (537M designs, one
   2^24-design chunk per table) through ``dse_eval``, timed with CUDA events;
   then the kernel against its plain version on every table's 2^24-design
   chunk, rtol 1e-6;
5. the mapping search (``repro_torch.mapspace.search``, no hand kernel
   on this path): vgg16-conv13's 72-group space (10368 mappings; pes 256,
   bw 32, edp, top-k 8, block 1024) searched exhaustively, cold and then
   warm, and greedily under a budget of 2048; each held against the JAX
   package's results in ``tests/data/torch_mapsearch_fixture.json`` (values
   and feature rows at rtol 1e-6, the same mappings evaluated, the top-k in
   the same order but for swaps within 1e-6 ties) and against the port's
   own search on the CPU; mappings/s end to end and steady; then one warm
   exhaustive search under ``torch.profiler`` (kernels and host-to-device
   copies per chunk, idle share, top device kernels and host operators);
5b. the front door (``repro_torch.api``, no hand kernel on this path):
   ``Session(cache_dir=None).run`` for vgg16-conv13's ``layer`` query (the
   session's default space; pes 256, bw 32, EDP, budget 600, block 1024,
   top-k 8; cold, then warm) and its ``layer_codse`` query (the default 128 x 128
   ``DSEConfig`` grid, codse top-k 4, 32 joint genes: 655,795 designs),
   each report held field by field against the JAX package's
   (``tests/data/torch_front_door_fixture.json``: points identical, values
   at rtol 1e-6, top-k swaps only within 1e-6 ties); wall, mappings/s or
   designs/s and the phase timing; ``Session.run_search`` bit-equal to
   ``search_impl`` on phase 5's space; the three launch counts 0;
5c. whole-network search and ``run_many`` (``repro_torch.netspace``, no
   hand kernel on this path): vgg16 at full width and depth (16 layers, 12
   unique shapes, 2 op-classes) through the CLIs' own queries —
   ``mapsearch --model vgg16 --layer all``'s 16-query batch through
   ``Session.run_many`` (coalesced, cold then warm, then
   ``coalesce=False``, which must give the same answers), ``netsearch
   --model vgg16`` (pes 256, bw 32, EDP, budget 512 per unique shape,
   frontier_k 8, fuse and reconfig on, block 1024; warm) and its
   ``--co-dse`` query (the 16 x 16 grid, frontier_k 4); each report held against the JAX
   package's (``tests/data/torch_netsearch_fixture.json``: points,
   segments and genes identical, values at rtol 1e-6); wall, mappings/s or
   designs/s end to end and warm-up passes; one warm ``network`` query
   under ``torch.profiler`` (idle share, kernels and host-to-device copies
   per ``evaluate_rows`` chunk); the three launch counts 0;
5d. the serving tier (``repro_torch.serve``, no hand kernel on this
   path): an in-process ``DSEServer`` on the card takes 5c's 16 vgg16
   queries as 16 concurrent ``POST /query`` requests (``max_batch`` 16, a
   30 s flush window: the size fires the flush), answering them in one
   flush as the JAX package's ``run_many`` (the netsearch fixture), with
   the ledger ``shed + completed == admitted`` and ``/healthz``,
   ``/readyz``, ``/metricsz`` (JSON and Prometheus) answering 200; then
   ``run_loadgen`` (8 clients x 2 requests: every request terminal, no
   transport error; queries/s, p50, p99); ``srv.drain()`` into a
   temporary directory (trace and metrics written); ``kill@serve-drain``
   with the 16 queries parked, and a fresh server recovering them at
   start, as the fixture; the three launch counts 0;
6. ``flash_attention`` against its plain version (``attention_ref``) with
   TF32 off, at the shapes of ``tests/test_kernels.py`` in float32 (2e-6,
   the SIMT kernel) and bf16 (2e-2, the wgmma kernel), then at the LLM
   path's shape (B=2, S=2048, 32 query heads over 8 KV heads, head dim 128,
   bf16, causal; 2e-2), each at every tile its kernel takes;
7. llama3-8b at full width and depth (32 layers, d_model 4096, d_ff 14336,
   vocab 128256) with random weights drawn on the card from seed 0:
   ``loss_fn`` at B=2, S=2048 (finite, near ln(vocab)), timed; the same
   forward with ``layers.flash_attention`` forced onto ``attention_ref``
   (loss within 1e-3 relative; the last logits' rel L2 printed);
8. the serving path: ``ServeEngine`` with 4 slots and max_len 1024 answers
   6 requests (prompt lengths 128-512 from seed 0, 32 new tokens each);
   then prefill-then-decode against the full-sequence forward on one
   prompt; then one forward and four decode steps under ``torch.profiler``
   for the card's busy and idle time;
9. the kernel at the LLM path's shape at each of its tiles, and the
   yardstick: ``torch.nn.functional.scaled_dot_product_attention`` there,
   timed as ``library_ms`` (the port never calls it);
10. ``linear_scan`` against its plain version (``linear_scan_ref``) with TF32
   off: the shapes of ``tests/test_kernels.py`` in float32 (1e-3) and bf16
   (5e-2), an odd chunk (T = c = 37) with a carried state, and full-size
   shapes in float32: rwkv6-1.6b's (B=2, T=2048, H=32, K=V=64, c=256, u,
   pre-update), ``HANDOFF_SCAN`` (B=2, T=2048, H=8, c=64: 32 chunks with a
   carried state and a weak decay, so the chunk-to-chunk hand-off carries
   most of o) and zamba2-7b's Mamba-2 scan (B=1, T=2048, H=112, K=V=64,
   c=256, post-update), and rwkv6's serving shapes, with u and float32
   inputs as the prefill gives them: B=4 at c = T = 64 and 96, B=1 at
   c = T = 127 (also with a carried state); o and the final state are both
   checked; at rwkv6's shape and ``HANDOFF_SCAN`` the kernel is also held
   within max(1e-6, 2x the plain version's own) rel L2 of a float64 scan;
11. rwkv6-1.6b at full width and depth (24 layers, d_model 2048, d_ff 7168,
   vocab 65536) with random weights drawn on the card from seed 0:
   ``loss_fn`` at B=2, S=2048 (finite; 24 launches), timed; the same
   forward with ``scan_op`` forced onto the plain version, in bf16 (loss
   within 1e-3 relative; the last logits' rel L2, argmaxes and top-2 gaps
   printed, the argmax not required: bf16 rounding flips decide it) and in
   float32 (loss within 1e-4, last logits within 1e-3 rel L2, argmax
   equal);
12. rwkv6-1.6b serving: ``ServeEngine`` with 4 slots answers 6 requests of
   64-token prompts x 32 new tokens (every re-prefill at most 96 wide; 24
   launches per prefill, 0 per decode step); prefill-then-decode against
   the full-sequence forward, in bf16 at S=128 (rel L2 0.2, argmax equal)
   and in float32 at S=48 (rel L2 1e-3); one forward and four decode steps
   under ``torch.profiler``.

13. training (``repro_torch.training``, ``ft``, ``checkpoint``): the
   ``flash_attention`` backward kernel against ``attention_bwd_ref`` (o
   and lse from the forward kernel, its lse held against the plain one;
   rel L2 of dq, dk, dv within 1e-5 in float32 and 2e-2 in bf16, bf16 also
   against the float32 formulas with the float32 o) at ragged small shapes
   and olmo-1b's and llama3-8b's (bf16 at D = 64, 128 on the wgmma
   backward, the rest on the SIMT one); olmo-1b
   at full width and depth (16 layers, d_model 2048, vocab 50304, bf16,
   seed 0) trains 3 steps at B=2, S=2048 through ``make_train_step`` and
   ``FaultTolerantLoop`` (checkpoints off at this size): finite loss and
   grad_norm, 32 forward and 16 backward flash launches a step (full
   remat runs each layer's forward again in the backward), tokens/s per
   step, peak memory, then one step under ``torch.profiler`` (tokens/s,
   busy share and the backward's share printed beside PR 25's); one step's
   loss and gradients on the kernel route against ``attention_ref`` under
   autograd, in bf16 (loss 1e-3, grad_norm 1e-2 relative) and on a float32
   copy (loss 1e-5, every gradient leaf 1e-4 rel L2, each printed); a
   checkpoint round trip of reduced olmo-1b on the card (bit-equal);
   reduced rwkv6-1.6b training on the card raises (no ``linear_scan``
   backward kernel, ROADMAP queue 2); then the backward timed at
   llama3-8b's and olmo-1b's shapes beside its plain version, SDPA's
   backward (``library_ms``) and the bound, with its delta pass timed
   apart and the forward timed with and without its lse store.

Kernel launch counts are set to 0 just before each path (``run_dse_full``;
one timed pass of the paper-scale sweep; the mapping search, the front
door, the network search and the serving tier, which must launch none;
one ``loss_fn`` forward of each model; each serving run; the olmo-1b
train steps) and read just after it.
The last two lines are the card's ``nvidia-smi`` name and power limit and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

PAPER_RATE = 0.17e6          # designs/s, the paper's §5.2 DSE
PEAK_FP32 = 67e12            # H100 SXM data sheet, float32 outside tensor cores
PEAK_BF16 = 989e12           # H100 SXM data sheet, dense bf16 tensor cores
BW_SXM, BW_PCIE = 3.35e12, 2.0e12   # H100 SXM / PCIe device memory, B/s
BYTES_PER_DESIGN = 8 + 20    # pes + bw in, 5 float32 features out
RTOL = 1e-6
# flash_attention vs attention_ref: float32 sums in another order (2e-6);
# bf16 outputs round to 8 mantissa bits (2e-2); tests/test_kernels.py's
FLASH_TOL = {torch.float32: 2e-6, torch.bfloat16: 2e-2}
FLASH_SHAPES = [  # tests/test_kernels.py:19-28, (B, Sq, Sk, Hq, Hkv, D, causal)
    (1, 128, 128, 2, 2, 64, True),
    (2, 256, 256, 4, 1, 64, True),
    (1, 256, 256, 8, 2, 128, True),
    (2, 128, 128, 2, 2, 64, False),
    (1, 512, 512, 2, 2, 64, True),
]
LLM_SHAPE = (2, 2048, 2048, 32, 8, 128, True)  # llama3-8b, loss_fn at S=2048
# linear_scan vs linear_scan_ref: float32 sums in another order behind the
# two-sided exp(+-P) factors (1e-3); bf16 inputs and outputs (5e-2);
# tests/test_kernels.py's
SCAN_TOL = {torch.float32: 1e-3, torch.bfloat16: 5e-2}
SCAN_SHAPES = [  # tests/test_kernels.py:57-67, (B, T, H, K, V, post, u, chunk)
    (1, 64, 1, 16, 16, False, True, 16),
    (2, 128, 2, 32, 32, False, True, 32),
    (1, 256, 4, 64, 64, True, False, 64),
    (2, 128, 2, 16, 48, True, False, 64),
]
SCAN_ODD = (2, 37, 2, 16, 24, False, True, 64)     # c = T = 37, with a state
RWKV_SCAN = (2, 2048, 32, 64, 64, False, True, 256)     # rwkv6-1.6b loss_fn
MAMBA_SCAN = (1, 2048, 112, 64, 64, True, False, 256)   # zamba2-7b's Mamba-2
# 32 chunks of 64 with a carried state0 and a weak decay (log_w * 0.01): the
# state handed from chunk to chunk carries most of o. At RWKV_SCAN every
# decay is clamped to -60/256, so the hand-off decays by e^-60 a chunk and
# a broken one would pass unseen there.
HANDOFF_SCAN = (2, 2048, 8, 64, 64, False, True, 64)
WEAK_DECAY = 0.01
# rwkv6-1.6b serving: the first prefill (c = T = 64), the widest re-prefill
# (96: a padded second 64-row query tile) and prefill-vs-decode's 127
SERVE_SCANS = [(4, 64, 32, 64, 64, False, True, 256),
               (4, 96, 32, 64, 64, False, True, 256),
               (1, 127, 32, 64, 64, False, True, 256)]


class SmokeError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


def log(*a) -> None:
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    check(bool(out), "nvidia-smi printed nothing")
    return out[0]


def time_ms(fn, reps: int, before=None) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` runs, by CUDA events,
    after one warm-up run; ``before()``, if given, runs between the two."""
    fn()
    torch.cuda.synchronize()
    if before is not None:
        before()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def vgg_tables():
    from repro_torch.core import dataflows, dnn_models
    from repro_torch.kernels.maestro_eval import build_tables
    out = []
    for op in dnn_models.vgg16():
        for flow in ("C-P", "X-P"):
            df = dataflows.table3_for_layer(flow, op)
            out.append((op, df, build_tables(op, df)))
    return out


def rel_err(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(max abs error, max of |got - want| / |want| where want != 0)."""
    d = (got - want).abs()
    denom = want.abs()
    rel = torch.where(denom > 0, d / denom, d)
    return float(d.max()), float(rel.max())


# ----------------------------------------------------------------------
# phases
# ----------------------------------------------------------------------

def phase_build() -> None:
    """All four kernel sources (maestro_eval, the flash forward, linear_scan,
    the flash backward), one nvcc each, started together; then the SASS of
    the flash forward library and of the flash backward library must each
    hold the tensor-core product and a TMA load."""
    from concurrent.futures import ThreadPoolExecutor
    from importlib import import_module
    from repro_torch.kernels import _build
    srcs = [(m.SRC, m.NVCC_FLAGS) for m in map(import_module, (
        "repro_torch.kernels.maestro_eval.maestro_eval",
        "repro_torch.kernels.flash_attention.flash_attention",
        "repro_torch.kernels.linear_scan.linear_scan"))]
    fa = import_module("repro_torch.kernels.flash_attention.flash_attention")
    srcs.append((fa.BWD_SRC, fa.NVCC_FLAGS))  # the backward, its own library
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(srcs)) as ex:
        done = [ex.submit(_build.build, *sf) for sf in srcs]
        results = [f.result() for f in done]
    for (src, _), (lib, seconds, report) in zip(srcs, results):
        log(f"[build] {lib.name}: {seconds:.2f} s")
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] ptxas {src.stem}: {line.strip()}")
    log(f"[build] wall {time.perf_counter() - t0:.2f} s")
    spills = ptxas_spills(results[3][2], "flash_bwd_wgmma_kernel")
    log(f"[build] ptxas spill bytes (stores, loads) of the wgmma backward "
        f"by instance: {spills or 'not rebuilt in this run'}")
    check(all(v == (0, 0) for v in spills.values()), "the wgmma flash "
          f"backward spills registers: {spills}")
    sass_check(results[1][0])
    sass_check(results[3][0])


def ptxas_spills(report: str, kernel: str) -> dict:
    """{mangled instance: (spill store bytes, spill load bytes)} of the
    entry functions whose name holds ``kernel``, from ``-Xptxas -v``'s
    report (empty when the library was not rebuilt)."""
    import re
    out, current = {}, None
    for line in report.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            current = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and current is not None and kernel in current:
            out[current] = (int(m.group(1)), int(m.group(2)))
        if m:
            current = None
    return out


def sass_check(lib: Path) -> None:
    """``cuobjdump -sass`` of a flash library (forward or backward): its
    wgmma kernel must compile to tensor-core products (HGMMA) fed by TMA
    loads (UTMALDG)."""
    import os
    import shutil
    tool = shutil.which("cuobjdump") or str(
        Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" /
        "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts = {op: sass.count(op) for op in ("HGMMA", "UTMALDG", "UTMASTG")}
    log(f"[build] SASS of {lib.name}: " +
        ", ".join(f"{op} {n}" for op, n in counts.items()))
    check(counts["HGMMA"] > 0 and counts["UTMALDG"] > 0, f"{lib.name}'s "
          "SASS holds no HGMMA or no UTMALDG: the bf16 kernel does not run "
          "on the tensor cores through TMA")


def phase_kernel_vs_plain(tables, device, n_random: int = 4096,
                          n_engine: int = 16) -> float:
    from repro_torch.core.model import analyze
    from repro_torch.core.performance import HWConfig
    from repro_torch.core.vectorized import batched_evaluator
    from repro_torch.kernels.maestro_eval import (closed_form_features,
                                                  maestro_eval)
    bws = torch.tensor([1.0, 2.0, 3.5, 8.0, 64.0, 128.0])
    pes = torch.arange(1, 16385, dtype=torch.int32)
    gp = pes.repeat_interleave(len(bws))
    gb = bws.repeat(len(pes))
    rng = np.random.default_rng(0)
    worst_abs = worst_rel = 0.0
    bit_equal = 0
    for op, df, T in tables:
        rp = torch.from_numpy(rng.integers(1, 16385, n_random,
                                           dtype=np.int32))
        rb = torch.from_numpy(rng.uniform(1, 1024, n_random)
                              .astype(np.float32))
        p = torch.cat([gp, rp]).to(device)
        b = torch.cat([gb, rb]).to(device)
        got = maestro_eval(p, b, tables=T)
        want = closed_form_features(p, b, T)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"{op.name} {df.name}: "
              "non-finite kernel output")
        a, r = rel_err(got, want)
        worst_abs, worst_rel = max(worst_abs, a), max(worst_rel, r)
        bit_equal += bool(torch.equal(got, want))
        check(r <= RTOL, f"{op.name} {df.name}: kernel vs plain rel err "
              f"{r:.3g} > {RTOL}")
        # runtime and macs against the batched evaluator on the card
        sub = slice(len(gp), len(gp) + 256)
        feats = batched_evaluator(op, df, device=device)(p[sub], b[sub])
        for kcol, bcol, name in ((0, 0, "runtime"), (1, 2, "macs")):
            ok = torch.isclose(got[sub, kcol], feats[:, bcol], rtol=1e-4,
                               atol=0)
            check(bool(ok.all()), f"{op.name} {df.name}: {name} vs "
                  "batched evaluator")
        # util against the faithful engine (Python ints: the batched
        # engine's PE-step counts wrap int32 on these layers)
        hp, hb = p[sub].cpu().numpy(), b[sub].cpu().numpy()
        hk = got[sub].cpu().numpy()
        for i in range(n_engine):
            s = analyze(op, df, HWConfig(num_pes=int(hp[i]),
                                         noc_bw=float(hb[i])))
            check(np.isclose(hk[i, 0], s.runtime, rtol=1e-4)
                  and np.isclose(hk[i, 1], s.total_macs, rtol=1e-4)
                  and np.isclose(hk[i, 3], s.utilization, atol=1e-5),
                  f"{op.name} {df.name}: kernel vs faithful engine at "
                  f"pes={hp[i]} bw={hb[i]}")
    log(f"[kernel-vs-plain] {len(tables)} tables x {len(gp) + n_random} "
        f"designs: max abs err {worst_abs:.6g}, max rel err "
        f"{worst_rel:.3g} (rtol {RTOL}); bit-equal on {bit_equal} of "
        f"{len(tables)} tables")
    return worst_abs


def phase_main_path(device, cfg=None, scales=(1, 2, 4, 8)) -> None:
    from repro_torch.core import dnn_models
    from repro_torch.core.dataflows import table3_for_layer
    from repro_torch.core.dse import DSEConfig, merge_results, run_dse_full
    from repro_torch.core.model import analyze
    from repro_torch.core.performance import HWConfig
    from repro_torch.core.dse import tile_variants
    cfg = cfg or DSEConfig()
    layers = {op.name: op for op in dnn_models.vgg16()}
    for lname in ("vgg16-conv2", "vgg16-conv11"):
        op = layers[lname]
        for flow in ("KC-P", "YR-P"):
            t0 = time.perf_counter()
            res = run_dse_full(op, flow, cfg, scales=scales, device=device)
            wall = time.perf_counter() - t0
            agg = merge_results(res)
            check(agg["n_valid"] > 0, f"{lname} {flow}: no valid design")
            for r in res:
                for f in ("runtime", "energy_pj", "throughput", "edp"):
                    col = np.asarray(getattr(r.stats, f))
                    check(col.shape == (r.n_evaluated,)
                          and bool(np.isfinite(col).all()),
                          f"{lname} {flow} {r.tile_tag}: bad {f} column")
            tb, eb = agg["best"]["throughput"], agg["best"]["energy"]
            check(tb["throughput"] >= eb["throughput"]
                  and eb["energy_pj"] <= tb["energy_pj"],
                  f"{lname} {flow}: §5.2 invariant broken")
            # int32 access counts wrap in the batched engine, in the
            # reference as in the port: count the designs it shows on
            n_neg = sum(int((np.asarray(r.stats.energy_pj) < 0).sum())
                        for r in res)
            # the winners, recomputed by the faithful engine
            dfs = dict(tile_variants(table3_for_layer(flow, op), scales))
            for obj in ("throughput", "energy", "edp"):
                p = agg["best"][obj]
                s = analyze(op, dfs[p["tile_tag"]],
                            HWConfig(num_pes=p["num_pes"],
                                     noc_bw=p["noc_bw"]))
                check(np.float32(s.runtime) == np.float32(p["runtime"]),
                      f"{lname} {flow} {obj}: runtime vs faithful engine")
            log(f"[run_dse_full] {lname} {flow}: n_evaluated "
                f"{agg['n_evaluated']} n_valid {agg['n_valid']} "
                f"designs/s {agg['rate_designs_per_s']:.6g} (grid "
                f"{agg['elapsed_s']:.4f} s, wall {wall:.3f} s), designs "
                f"with negative (int32-wrapped) energy {n_neg}")
            for obj in ("throughput", "energy", "edp"):
                p = agg["best"][obj]
                log(f"[run_dse_full]   best {obj}: pes {p['num_pes']} bw "
                    f"{p['noc_bw']} tile {p['tile_tag']} throughput "
                    f"{p['throughput']:.6g} energy_pj {p['energy_pj']:.6g} "
                    f"edp {p['edp']:.6g} area {p['area_mm2']:.4f} power "
                    f"{p['power_mw']:.4f}")


def profile_call(fn, label: str, device, kernel: str | None = None) -> dict:
    """Where one call of ``fn`` spends its time: the card's busy time
    (kernels and copies, by ``torch.profiler``) against the call's wall
    time, the device kernels and host operators that dominate, and the
    device time and share of busy time of the kernels whose name holds
    ``kernel``.  One warm-up call, one unprofiled and one profiled call.
    Returns the unprofiled and the profiled call's wall, the busy seconds
    and the device time by name ({name: [count, us]})."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    sync(device)
    t0 = time.perf_counter()
    fn()
    sync(device)
    plain_wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync(device)
        wall = time.perf_counter() - t0
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_s = sum(e.time_range.elapsed_us() for e in dev) / 1e6
    by_name: dict[str, list] = {}
    for e in dev:
        s = by_name.setdefault(e.name, [0, 0.0])
        s[0] += 1
        s[1] += e.time_range.elapsed_us()
    log(f"[profile] {label}: wall {plain_wall:.4f} s unprofiled, "
        f"{wall:.4f} s profiled; device busy {busy_s:.6f} s in {len(dev)} "
        f"kernels and copies: idle share {1 - busy_s / wall:.4f}")
    for name, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1]
                                )[:5]:
        log(f"[profile]   device {us / 1e3:.3f} ms ({us / 1e6 / busy_s:.4f} "
            f"of busy) in {n} x {name[:70]}")
    if kernel is not None:
        n, us = (sum(v[i] for k, v in by_name.items() if kernel in k)
                 for i in (0, 1))
        log(f"[profile]   {kernel}: device {us / 1e3:.3f} ms in {n} "
            f"launches, {us / 1e6 / max(busy_s, 1e-12):.4f} of busy")
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    for e in host[:6]:
        log(f"[profile]   host self {e.self_cpu_time_total / 1e3:.3f} ms in "
            f"{e.count} x {e.key[:70]}")
    return {"plain_wall": plain_wall, "wall": wall, "busy": busy_s,
            "by_name": by_name}


def profile_run_dse(device, cfg=None) -> None:
    """One ``run_dse`` call at the default grid."""
    from repro_torch.core import dnn_models
    from repro_torch.core.dataflows import table3_for_layer
    from repro_torch.core.dse import DSEConfig, run_dse
    cfg = cfg or DSEConfig()
    op = next(o for o in dnn_models.vgg16() if o.name == "vgg16-conv11")
    df = table3_for_layer("KC-P", op)
    n = run_dse(op, df, cfg, device=device).n_evaluated
    profile_call(lambda: run_dse(op, df, cfg, device=device),
                 f"run_dse vgg16-conv11 KC-P base, {n} designs", device)


def sweep_inputs(device, n_pes: int = 16384, n_bw: int = 1024):
    pes = torch.arange(1, n_pes + 1, dtype=torch.int32,
                       device=device).repeat_interleave(n_bw)
    bw = torch.arange(1, n_bw + 1, dtype=torch.float32,
                      device=device).repeat(n_pes)
    return pes, bw


def phase_paper_scale(tables, device, n_pes: int = 16384,
                      n_bw: int = 1024) -> tuple[int, float, float]:
    """The sweep, timed over one pass after a warm-up pass; the launch count
    is set to 0 just before the timed pass and read just after it.  Then the
    kernel against its plain version on every table's chunk, the shape the
    sweep launches it at.  Returns (launches, max abs error, sweep ms)."""
    from repro_torch.kernels.maestro_eval import (closed_form_features,
                                                  dse_eval, maestro_eval)
    pes, bw = sweep_inputs(device, n_pes, n_bw)
    n = pes.numel()
    best = [None] * len(tables)

    def sweep():
        for i, (_, _, T) in enumerate(tables):
            out = dse_eval(pes, bw, tables=T)
            idx = torch.argmax(out[:, 2])  # harness: best throughput
            best[i] = (idx, out[idx])

    def reset():
        maestro_eval.launches = 0
    ms = time_ms(sweep, 1, before=reset)
    launches = maestro_eval.launches
    log(f"[launches] paper-scale sweep: maestro_eval {launches}")
    check(launches == len(tables), f"the paper-scale sweep launched "
          f"maestro_eval {launches} times, not once per table")
    total = n * len(tables)
    rate = total / (ms / 1e3)
    log(f"[paper-scale] {len(tables)} tables x {n_pes} pes x {n_bw} bw = "
        f"{total} designs in {ms:.3f} ms: {rate:.6g} designs/s "
        f"({rate / PAPER_RATE:.6g}x the paper's 0.17M designs/s)")
    for (op, df, T), (idx, row) in zip(tables, best):
        i, out = int(idx), row.tolist()
        log(f"[paper-scale]   {op.name} {df.name}: best throughput "
            f"{out[2]:.6g} MACs/cycle at pes {int(pes[i])} bw "
            f"{float(bw[i])} (runtime {out[0]:.6g}, util {out[3]:.6g})")
    worst_abs = worst_rel = 0.0
    bit_equal = 0
    for op, df, T in tables:
        got = maestro_eval(pes, bw, tables=T)
        want = closed_form_features(pes, bw, T)
        check(bool(torch.isfinite(got).all()), f"{op.name} {df.name}: "
              f"non-finite kernel output on the {n}-design chunk")
        a, r = rel_err(got, want)
        worst_abs, worst_rel = max(worst_abs, a), max(worst_rel, r)
        bit_equal += bool(torch.equal(got, want))
        check(r <= RTOL, f"{op.name} {df.name}: kernel vs plain rel err "
              f"{r:.3g} > {RTOL} on the {n}-design chunk")
        del got, want
    log(f"[paper-scale] kernel vs plain on {len(tables)} tables x {n} "
        f"designs: max abs err {worst_abs:.6g}, max rel err "
        f"{worst_rel:.3g} (rtol {RTOL}); bit-equal on {bit_equal} of "
        f"{len(tables)} tables")
    return launches, worst_abs, ms


# ----------------------------------------------------------------------
# The mapping search (repro_torch.mapspace): no hand kernel on this path
# ----------------------------------------------------------------------

FIXTURE = ROOT / "tests" / "data" / "torch_mapsearch_fixture.json"
MAPSEARCH_CASES = ("conv13/exhaustive", "conv13/greedy")
MAPSEARCH_RTOL = 1e-6


def _load_script(name: str):
    """``scripts/<name>.py`` as a module.  Both fixture scripts import
    numpy or the stdlib at module level and JAX only in their ``main``;
    their case lists and comparisons are what this script holds the port
    to."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def near(a: float, b: float, rtol: float = MAPSEARCH_RTOL) -> bool:
    return abs(a - b) <= rtol * abs(b)


def same_ranking(label: str, got: list, want: list) -> int:
    """``got`` and ``want`` are [(point, value, stats)] best first.  Values
    and stats at rtol 1e-6; the points in the same order, except that
    entries whose ``want`` values lie within 1e-6 of each other may swap
    (and at the end of the list, a point of such a tie from outside
    ``want`` may come in).  Returns how many positions were swapped."""
    check(len(got) == len(want), f"{label}: top-k of {len(got)}, "
          f"not {len(want)}")
    by_point = {p: (v, s) for p, v, s in want}
    swapped = 0
    for i, ((gp, gv, gs), (wp, wv, _)) in enumerate(zip(got, want)):
        check(near(gv, wv), f"{label}: value {gv!r} at {i} is not "
              f"{wv!r} within {MAPSEARCH_RTOL}")
        if gp != wp:
            swapped += 1
            if gp in by_point:
                check(near(by_point[gp][0], wv), f"{label}: {gp} at {i} "
                      f"swapped with {wp} outside a tie")
            else:
                check(all(near(v, wv) for _, v, _ in want[i:]),
                      f"{label}: {gp} at {i} is not in the reference's "
                      f"top-k and not in its last tie")
        ref = by_point.get(gp)
        if ref is not None:
            for k, v in ref[1].items():
                check(near(gs[k], v), f"{label}: {gp} {k} {gs[k]!r} vs "
                      f"{v!r}")
    return swapped


def ranking(r) -> list:
    return [(tuple(e["point"]), e["value"], e["stats"]) for e in r.top_k]


def profile_search(fn, label: str, device, tag: str = "mapsearch-profile",
                   host: bool = True) -> None:
    """One warm search under ``torch.profiler``: wall, the card's busy time
    and idle share, kernels and host-to-device copies per chunk (a chunk
    is one dispatch of the reduced evaluator, counted by the
    ``universal.warm_hits`` counter, which the network evaluator's
    ``evaluate_rows`` chunks count too), the top device kernels and the
    top host operators by self time (with ``host``: recording the host's
    operators costs the profiler's post-processing seconds, so a caller
    after the device side alone records only the card's activity); each
    line starts with ``[tag]``."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import obs
    def hits() -> float:
        return sum(obs.metrics().counters("universal.warm_hits").values())
    h0 = hits()
    activities = [ProfilerActivity.CUDA] if device.type == "cuda" else []
    if host or not activities:
        activities.append(ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        sync(device)
        wall = time.perf_counter() - t0
    chunks = int(hits() - h0)
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_s = sum(e.time_range.elapsed_us() for e in dev) / 1e6
    h2d = [e for e in dev if "HtoD" in e.name]
    copies = [e for e in dev if "Memcpy" in e.name or "Memset" in e.name]
    kernels = len(dev) - len(copies)
    log(f"[{tag}] {label}: wall {wall:.4f} s profiled; device "
        f"busy {busy_s:.6f} s: idle share {1 - busy_s / wall:.4f}; "
        f"{chunks} chunks, {kernels} kernels ({kernels / max(chunks, 1):.1f}"
        f" a chunk), {len(h2d)} host-to-device copies "
        f"({len(h2d) / max(chunks, 1):.1f} a chunk), {len(copies)} copies "
        f"and sets in all")
    by_name: dict[str, list] = {}
    for e in dev:
        s = by_name.setdefault(e.name, [0, 0.0])
        s[0] += 1
        s[1] += e.time_range.elapsed_us()
    for name, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1]
                                )[:6]:
        log(f"[{tag}]   device {us / 1e3:.3f} ms "
            f"({us / 1e6 / max(busy_s, 1e-12):.4f} of busy) in {n} x "
            f"{name[:70]}")
    if not host:
        return
    ops = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    for e in ops[:8]:
        log(f"[{tag}]   host self "
            f"{e.self_cpu_time_total / 1e3:.3f} ms in {e.count} x "
            f"{e.key[:70]}")


def phase_mapsearch(device, cases=MAPSEARCH_CASES, card: str = "") -> None:
    """The mapping search through ``repro_torch.mapspace.search`` on
    ``device``: the exhaustive search of vgg16-conv13's 72-group space
    (10368 mappings; num_pes 256, noc_bw 32, edp, top-k 8, block 1024),
    cold and then warm, and a greedy search of it under a budget of 2048
    (``auto`` resolves to greedy); each held against the JAX package's
    results (``tests/data/torch_mapsearch_fixture.json``) and against the
    same search by the port on the CPU in this process; mappings/s end to
    end and steady; then one warm exhaustive search under
    ``torch.profiler``.  No hand-written kernel is on this path (the
    reference's has no Pallas kernel either)."""
    from repro_torch import mapspace
    from repro_torch.core import dnn_models, tensor_analysis
    mk = _load_script("make_mapsearch_fixture")
    want = json.loads(FIXTURE.read_text())["cases"]
    for name in cases:
        case = want[name]
        op, space, kw = mk.build_case(case["spec"], tensor_analysis,
                                      dnn_models, mapspace)
        check((space.size, space.n_groups) ==
              (case["space_size"], case["space_groups"]),
              f"{name}: space of {space.size} mappings in {space.n_groups}"
              f" groups, not {case['space_size']} in "
              f"{case['space_groups']}")
        runs = [("cold", device), ("warm", device)] \
            if name.endswith("exhaustive") else [("warm", device)]
        results = []
        for tag, dev in runs + [("cpu", torch.device("cpu"))]:
            t0 = time.perf_counter()
            r = mapspace.search(op, space=space, device=dev, **kw)
            sync(device)
            wall = time.perf_counter() - t0
            results.append(r)
            ref = case["result"]
            check(r.strategy == ref["strategy"], f"{name}: strategy "
                  f"{r.strategy}, not {ref['strategy']}")
            check(r.n_evaluated == ref["n_evaluated"], f"{name} {tag}: "
                  f"{r.n_evaluated} mappings evaluated, not "
                  f"{ref['n_evaluated']}")
            check(r.n_groups == ref["n_groups"], f"{name} {tag}: "
                  f"{r.n_groups} groups, not {ref['n_groups']}")
            check(all(np.isfinite(v) for e in r.top_k
                      for v in e["stats"].values()),
                  f"{name} {tag}: non-finite stats in the top-k")
            swaps = same_ranking(
                f"{name} {tag} vs JAX", ranking(r),
                [(tuple(e["point"]), e["value"], e["stats"])
                 for e in ref["top_k"]])
            log(f"[mapsearch] {name} {tag} on {dev.type}: {r.strategy}, "
                f"{r.n_evaluated} mappings in {r.n_groups} groups, best "
                f"{r.best_value!r} at {r.best_point} (JAX "
                f"{ref['best_value']!r} at {tuple(ref['best_point'])}); "
                f"top-{len(r.top_k)} as the JAX package's, {swaps} tied "
                f"swaps; wall {wall:.4f} s, warm-up passes {r.n_compiles} "
                f"({r.compile_s:.4f} s), encode {r.encode_s:.4f} s, eval "
                f"{r.eval_s:.4f} s; {r.end_to_end_mappings_per_s:.6g} "
                f"mappings/s end to end, {r.mappings_per_s:.6g} steady"
                + (f" ({card})" if dev.type == "cuda" and card else ""))
        same_ranking(f"{name} {device.type} vs cpu", ranking(results[-2]),
                     ranking(results[-1]))
    name = cases[0]
    op, space, kw = mk.build_case(want[name]["spec"], tensor_analysis,
                                  dnn_models, mapspace)
    profile_search(lambda: mapspace.search(op, space=space, device=device,
                                           **kw),
                   f"{name} warm, {space.size} mappings", device)


# ----------------------------------------------------------------------
# The front door (repro_torch.api): no hand kernel on this path either
# ----------------------------------------------------------------------

FRONT_DOOR_FIXTURE = ROOT / "tests" / "data" / "torch_front_door_fixture.json"
FRONT_DOOR_CASES = ("layer", "layer_codse")


def phase_front_door(device, cases=FRONT_DOOR_CASES, card: str = "") -> None:
    """``Session(cache_dir=None).run`` on ``device`` for vgg16-conv13: the
    ``layer`` query (the session's default space; pes 256, bw 32, EDP,
    budget 600, block 1024, top-k 8; cold, then warm) and the
    ``layer_codse`` query (the
    same layer at the default 128 x 128 ``DSEConfig`` grid, codse top-k 4,
    32 joint genes), each held against the JAX package's report
    (``tests/data/torch_front_door_fixture.json``: the same query JSON and
    fingerprint; every report field but the timings, points identical and
    values at rtol 1e-6, top-k swaps only within 1e-6 ties); wall,
    mappings/s or designs/s and the phase timing; then ``Session.run_search``
    against ``search_impl`` on phase 5's 72-group space, bit for bit."""
    from repro_torch import mapspace
    from repro_torch.api import Query, Session
    from repro_torch.core import dnn_models, tensor_analysis
    from repro_torch.core.dse import DSEConfig
    from repro_torch.mapspace.search import search_impl
    fx = _load_script("make_front_door_fixture")
    want = json.loads(FRONT_DOOR_FIXTURE.read_text())["cases"]
    session = Session(cache_dir=None, device=device)
    on = f" ({card})" if device.type == "cuda" and card else ""
    for name in cases:
        d = fx.query_json(fx.CASES[name], DSEConfig)
        check(d == want[name]["query"], f"{name}: the query is not the "
              f"fixture's")
        q = Query.from_json(d)
        check(q.kind == name and q.fingerprint() == want[name]["fingerprint"],
              f"{name}: kind {q.kind}, fingerprint {q.fingerprint()}, not "
              f"the reference's {want[name]['fingerprint']}")
        # the layer query twice: its first passes, then warm
        for tag in ("cold", "warm") if name == "layer" else ("cold",):
            t0 = time.perf_counter()
            rep = session.run(q)
            sync(device)
            wall = time.perf_counter() - t0
            try:
                swaps = fx.compare_reports(rep.to_json(),
                                           want[name]["report"])
            except AssertionError as e:
                raise SmokeError(f"{name} report vs JAX: {e}") from e
            timing = json.dumps(rep.extras["timing"])
            if name == "layer":
                log(f"[front-door] layer {rep.name} {tag} on {device.type}: "
                    f"{rep.strategy}, {rep.n_evaluated} mappings, best "
                    f"{rep.best['value']!r} at {rep.best['point']}; report "
                    f"as the JAX package's, {swaps} tied swaps; wall "
                    f"{wall:.4f} s, {rep.n_evaluated / wall:.6g} mappings/s "
                    f"end to end (engine's own "
                    f"{rep.rates['end_to_end_mappings_per_s']:.6g}, steady "
                    f"{rep.rates['mappings_per_s']:.6g}); timing "
                    f"{timing}{on}")
                continue
            j = rep.extras["joint"]
            bests = "; ".join(
                f"{obj} {b[obj if obj != 'energy' else 'energy_pj']!r} at "
                f"pes {b['num_pes']} bw {b['noc_bw']} {b['mapping']}"
                for obj, b in rep.best["per_objective"].items())
            log(f"[front-door] layer_codse {rep.name} on {device.type}: "
                f"{rep.n_evaluated} designs evaluated ({j['n_designs']} in "
                f"the joint sweep, {j['n_valid']} valid), Pareto front of "
                f"{len(rep.pareto)}; report as the JAX package's, {swaps} "
                f"tied swaps; wall {wall:.4f} s, "
                f"{rep.n_evaluated / wall:.6g} designs/s end to end, joint "
                f"sweep {j['designs_per_s']:.6g} designs/s; bests: {bests}; "
                f"timing {timing}{on}")
    mk = _load_script("make_mapsearch_fixture")
    case = json.loads(FIXTURE.read_text())["cases"][MAPSEARCH_CASES[0]]
    op, space, kw = mk.build_case(case["spec"], tensor_analysis, dnn_models,
                                  mapspace)
    a = search_impl(op, space=space, device=device, **kw)
    b = Session(cache_dir=None, device=device).run_search(op, space=space,
                                                          **kw)
    check((a.best_point, a.best_value, a.best_stats, a.top_k, a.n_evaluated)
          == (b.best_point, b.best_value, b.best_stats, b.top_k,
              b.n_evaluated), "Session.run_search is not search_impl bit "
          "for bit")
    log(f"[front-door] Session.run_search on {MAPSEARCH_CASES[0]}: bit-equal "
        f"to search_impl ({a.n_evaluated} mappings, best {a.best_value!r})")


# ----------------------------------------------------------------------
# Whole-network search and run_many (repro_torch.netspace): no hand kernel
# ----------------------------------------------------------------------

NETSEARCH_FIXTURE = ROOT / "tests" / "data" / "torch_netsearch_fixture.json"


def phase_netsearch(device, card: str = "") -> None:
    """vgg16 at full width and depth (16 layers, 12 unique shapes, 2
    op-classes) through the port's CLIs' own queries, on ``device``:
    ``mapsearch --model vgg16 --layer all``'s batch (16 layer queries,
    budget 1000, top-k 5) through ``Session.run_many``, coalesced (cold,
    then warm), then with ``coalesce=False``; ``netsearch --model
    vgg16``'s ``network`` query (pes 256, bw 32, EDP, budget 512 per
    unique shape, frontier_k 8, fuse and reconfig on, block 1024; warm:
    the batch warmed its op-classes' evaluators) and ``netsearch --model
    vgg16 --co-dse``'s ``network_codse`` query (the 16 x 16 grid,
    frontier_k 4).  Each report is held against the JAX
    package's (``tests/data/torch_netsearch_fixture.json``: the same
    fingerprints; points, segments and genes identical, values at rtol
    1e-6); ``coalesce=False`` must give the coalesced answers.  Wall,
    mappings/s (designs/s) end to end and warm-up passes are printed; then
    one warm ``network`` query under ``torch.profiler``.  No hand-written
    kernel is on this path (the reference's has no Pallas kernel
    either)."""
    from repro_torch.api import Session, select_layers
    from repro_torch.core import dnn_models
    from repro_torch.launch import mapsearch, netsearch
    fx = _load_script("make_front_door_fixture")
    want = json.loads(NETSEARCH_FIXTURE.read_text())["cases"]
    on = f" ({card})" if device.type == "cuda" and card else ""
    net_q, co_q = netsearch.network_queries(netsearch.build_parser()
                                            .parse_args(["--model", "vgg16",
                                                         "--co-dse"]))
    session = Session(cache_dir=None, device=device)

    def held(label: str, rep, ref: dict) -> int:
        try:
            return fx.compare_reports(rep.to_json(), ref)
        except AssertionError as e:
            raise SmokeError(f"{label} report vs JAX: {e}") from e

    case = want["run_many"]
    args = mapsearch.build_parser().parse_args(["--model", "vgg16",
                                                "--layer", "all"])
    qs = mapsearch.layer_queries(
        select_layers(dnn_models.MODELS[args.model](), args.layer), args)
    check([q.fingerprint() for q in qs] == case["fingerprints"],
          "run_many: the mapsearch CLI's --layer all batch is not the "
          "fixture's")
    answers = []
    # first in the phase, so its first batch is the cold one: the batch's
    # family spaces and the network queries' share their op-classes'
    # evaluators (the same first layers, the same block)
    for tag, coalesce in (("cold", True), ("warm", True),
                          ("coalesce=False", False)):
        t0 = time.perf_counter()
        reps = session.run_many(qs, coalesce=coalesce)
        sync(device)
        wall = time.perf_counter() - t0
        batch = session.last_batch
        n = sum(r.n_evaluated for r in reps)
        if coalesce:
            check(fx.batch_stats(batch) == case["batch"], f"run_many: "
                  f"batch {fx.batch_stats(batch)}, not {case['batch']}")
            check(batch["n_compiles"] <= min(batch["n_families"],
                                             batch["compile_budget"]),
                  f"run_many: {batch['n_compiles']} warm-up passes over "
                  f"{batch['n_families']} families")
            swaps = sum(held(f"run_many {r.name}", r, w)
                        for r, w in zip(reps, case["reports"]))
        else:
            check([r.results_json() for r in reps] == answers[0],
                  "run_many: coalesce=False differs from the coalesced "
                  "answers")
            swaps = 0
        answers.append([r.results_json() for r in reps])
        log(f"[netsearch] run_many vgg16 --layer all {tag} on "
            f"{device.type}: {len(reps)} queries, {n} mappings in "
            f"{batch['n_families']} family passes; reports as the JAX "
            f"package's ({swaps} tied swaps); wall {wall:.4f} s, "
            f"{n / wall:.6g} mappings/s end to end; warm-up passes "
            f"{batch['n_compiles']} of budget {batch['compile_budget']} "
            f"({batch['compile_s']} s), encode {batch['encode_s']} s, eval "
            f"{batch['eval_s']} s{on}")
    for name, q in (("network", net_q), ("network_codse", co_q)):
        check(q.kind == name and q.fingerprint() == want[name]["fingerprint"],
              f"{name}: kind {q.kind}, fingerprint {q.fingerprint()}, not "
              f"the fixture's {want[name]['fingerprint']}")
        for tag in ("warm",):
            t0 = time.perf_counter()
            rep = session.run(q)
            sync(device)
            wall = time.perf_counter() - t0
            swaps = held(name, rep, want[name]["report"])
            what = "mappings" if name == "network" else "designs"
            b = rep.best if name == "network" else rep.best["schedule"]
            log(f"[netsearch] {name} vgg16 {tag} on {device.type}: "
                f"{rep.n_evaluated} {what} evaluated, network EDP "
                f"{b['edp']!r}, cost {b['cost']!r}, segments "
                f"{len(b['segments'])}, reconfigs {b['n_reconfigs']}"
                + (f", {rep.extras['n_valid']} of {rep.extras['n_hw']} "
                   f"designs valid, Pareto front of {len(rep.pareto)}"
                   if name == "network_codse" else "")
                + f"; report as the JAX package's ({swaps} tied swaps); "
                f"wall {wall:.4f} s, {rep.n_evaluated / wall:.6g} {what}/s "
                f"end to end; warm-up passes {rep.n_compiles} "
                f"({rep.compile_s:.4f} s), encode {rep.encode_s:.4f} s, "
                f"eval {rep.eval_s:.4f} s; timing "
                f"{json.dumps(rep.extras['timing'])}{on}")

    n_net = want["network"]["report"]["n_evaluated"]
    profile_search(lambda: session.run(net_q),
                   f"network vgg16 warm, {n_net} mappings", device,
                   tag="netsearch-profile", host=False)




def wire_query(q) -> dict:
    """A layer query of the zoo in the serving tier's wire format (the
    ``examples/queries.json`` schema): the op as its builder's arguments,
    the hardware and search as ``describe()`` gives them, so that
    ``Query.from_json`` rebuilds the same query and fingerprint."""
    d = q.describe()
    (op,) = q.workload.ops
    dims = {k.lower(): v for k, v in op.dims.items()}
    if op.op_type == "CONV2D":
        wop = {"type": "conv2d", **{k: dims[k] for k in "nkcyxrs"}}
    elif op.op_type == "FC":
        wop = {"type": "fc", **{k: dims[k] for k in "nkc"}}
    else:
        raise SmokeError(f"no wire form for {op.op_type}")
    return {"workload": {"op": {"name": op.name, **wop}},
            "hardware": d["hardware"], "search": d["search"]}


def phase_serve(device, card: str = "") -> None:
    """The serving tier (``repro_torch.serve``, no hand kernel on this
    path) on ``device``, in process: a ``DSEServer`` with ``max_batch`` 16,
    a 30 s flush window and a 600 s default deadline takes the 16 queries
    of ``mapsearch --model vgg16 --layer all`` (phase 5c's batch) as 16
    concurrent ``POST /query`` requests: one flush must answer them all,
    each report held against the JAX package's ``run_many`` answers
    (``tests/data/torch_netsearch_fixture.json``: fingerprints identical,
    values at rtol 1e-6, top-k swaps only within 1e-6 ties), the ledger
    ``shed + completed == admitted`` must hold, and ``/healthz``,
    ``/readyz`` and both ``/metricsz`` formats must answer 200.  Then
    ``run_loadgen`` (8 clients x 2 requests over the same queries) against
    a server that flushes every 8: every request terminal, no transport
    error; queries/s, p50 and p99 printed.  Then ``srv.drain()`` into a
    temporary directory (``serve-trace.json``, ``serve-metrics.json``
    there), and ``kill@serve-drain`` on a server holding the 16 queries
    parked: the drain persists them and dies before its flush, and a
    fresh server recovers them at start, answering as the fixture."""
    import asyncio
    import tempfile

    from repro_torch import obs
    from repro_torch.api import Query, Session, select_layers
    from repro_torch.core import dnn_models
    from repro_torch.launch import mapsearch
    from repro_torch.resilience import ResilienceConfig, faultinject
    from repro_torch.serve import (DSEServer, ServeConfig, http_json,
                                   http_text, run_loadgen)
    from repro_torch.serve import drain as drainmod
    fx = _load_script("make_front_door_fixture")
    case = json.loads(NETSEARCH_FIXTURE.read_text())["cases"]["run_many"]
    by_name = {r["name"]: r for r in case["reports"]}
    on = f" ({card})" if device.type == "cuda" and card else ""
    args = mapsearch.build_parser().parse_args(["--model", "vgg16",
                                                "--layer", "all"])
    qs = mapsearch.layer_queries(
        select_layers(dnn_models.MODELS[args.model](), args.layer), args)
    wire = [wire_query(q) for q in qs]
    check([Query.from_json(w).fingerprint() for w in wire]
          == case["fingerprints"], "serve: the wire queries are not the "
          "fixture's --layer all batch")
    met = obs.metrics()
    host = "127.0.0.1"
    session = Session(cache_dir=None, device=device)

    def held(label: str, body: dict) -> int:
        try:
            return fx.compare_reports(body, by_name[body["name"]])
        except (AssertionError, KeyError) as e:
            raise SmokeError(f"serve: {label} {body.get('name')} vs JAX: "
                             f"{e}") from e

    def held_slice(label: str, got: dict) -> int:
        want = by_name[got["name"]]
        return held(label, {k: got[k] if k in got else want[k]
                            for k in want})

    async def post_all(srv, timeout: float = 600.0) -> list:
        return await asyncio.gather(*(http_json(
            host, srv.port, "POST", "/query", w, timeout=timeout)
            for w in wire))

    async def until(cond, what: str, limit_s: float = 60.0) -> None:
        t_end = time.monotonic() + limit_s
        while not cond():
            check(time.monotonic() < t_end, f"serve: {what} not met in "
                  f"{limit_s} s")
            await asyncio.sleep(0.02)

    async def one_flush() -> None:
        srv = DSEServer(session, ServeConfig(
            port=0, exit_on_kill=False, max_batch=16, flush_interval_s=30.0,
            default_deadline_s=600))
        await srv.start()
        try:
            flushes0 = met.value("serve.flushes")
            t0 = time.perf_counter()
            res = await post_all(srv)
            wall = time.perf_counter() - t0
            check([st for st, _ in res] == [200] * 16,
                  f"serve: statuses {[st for st, _ in res]}")
            check({b["kind"] for _, b in res} == {"layer"},
                  f"serve: kinds {sorted({b['kind'] for _, b in res})}")
            n_flush = met.value("serve.flushes") - flushes0
            check(n_flush == 1, f"serve: {n_flush} flushes, not 1")
            swaps = sum(held("served", b) for _, b in res)
            check(fx.batch_stats(session.last_batch) == case["batch"],
                  f"serve: batch {fx.batch_stats(session.last_batch)}")
            await until(lambda: srv.coalescer.depth() == 0, "empty queue")
            codes = {}
            for path in ("/healthz", "/readyz", "/metricsz"):
                codes[path], body = await http_json(host, srv.port, "GET",
                                                    path)
            snap = body
            codes["prometheus"], text = await http_text(
                host, srv.port, "GET", "/metricsz?format=prometheus")
            check(set(codes.values()) == {200}, f"serve: endpoints {codes}")
            check("# TYPE serve_requests counter" in text,
                  "serve: no Prometheus counters")
            c = snap["counters"]
            check(c.get("serve.shed", 0) + c["serve.completed"]
                  == c["serve.admitted"], f"serve: ledger shed "
                  f"{c.get('serve.shed', 0)} + completed "
                  f"{c['serve.completed']} != admitted {c['serve.admitted']}")
            lat = sorted(b["timing"]["wall_s"] for _, b in res)
            log(f"[serve] 16 concurrent vgg16 --layer all queries on "
                f"{device.type}: 1 flush of 16 in {wall:.4f} s wall "
                f"({16 / wall:.6g} queries/s), server walls "
                f"{lat[0]:.4f}-{lat[-1]:.4f} s; reports as the JAX "
                f"package's ({swaps} tied swaps); endpoints {codes}; ledger "
                f"shed {c.get('serve.shed', 0)} + completed "
                f"{c['serve.completed']} == admitted "
                f"{c['serve.admitted']}{on}")
        finally:
            await srv.stop()

    async def loadgen_and_drain(out_dir: str) -> None:
        srv = DSEServer(session, ServeConfig(
            port=0, exit_on_kill=False, max_batch=8, flush_interval_s=30.0,
            default_deadline_s=600, flight_dir=out_dir))
        await srv.start()
        try:
            lg = await run_loadgen(host, srv.port, wire, clients=8,
                                   requests_per_client=2, timeout=600.0)
            s = lg.summary()
            check(lg.n_terminal == lg.n_requests == 16
                  and lg.transport_errors == 0 and s["statuses"] == {
                      "200": 16}, f"serve: loadgen {s}")
            # 8-query flushes are other batches than the fixture's 16 (the
            # unit of bit-equality is the flush): kinds only
            kinds = {body["kind"] for _, body in lg.reports}
            check(kinds == {"layer"}, f"serve: loadgen kinds {kinds}")
            log(f"[serve] loadgen 8 clients x 2 requests on "
                f"{device.type}: {s['n_terminal']} of {s['n_requests']} "
                f"terminal, {s['transport_errors']} transport errors, "
                f"statuses {s['statuses']}; {s['queries_per_s']} "
                f"queries/s, p50 {s['p50_s']} s, p99 {s['p99_s']} s, wall "
                f"{s['wall_s']} s{on}")
            await srv.drain()
        finally:
            await srv.stop()
        for name in (drainmod.TRACE_NAME, drainmod.METRICS_NAME):
            check(os.path.exists(os.path.join(out_dir, name)),
                  f"serve: drain wrote no {name}")
        log(f"[serve] drain wrote {drainmod.TRACE_NAME} and "
            f"{drainmod.METRICS_NAME}")

    async def killed_drain(ck: str, out_dir: str) -> None:
        # the parked requests end by their 5 s deadline: the 30 s window
        # and a batch of 64 fire no flush, and the drain dies before its
        # own
        sess = Session(cache_dir=None, device=device,
                       resilience=ResilienceConfig(
                           ckpt_dir=ck, faults="kill@serve-drain:0"))
        srv = DSEServer(sess, ServeConfig(
            port=0, exit_on_kill=False, max_batch=64, flush_interval_s=30.0,
            default_deadline_s=5.0, grace_s=1.0, flight_dir=out_dir))
        await srv.start()
        posts = asyncio.ensure_future(post_all(srv, timeout=120.0))
        await until(lambda: srv.coalescer.depth() == 16, "16 parked")
        await srv.drain()
        check(os.path.exists(drainmod.pending_path(ck)),
              "serve: the killed drain persisted no pending file")
        res = await posts
        check({b["kind"] for _, b in res} == {"timeout"},
              f"serve: parked answers {sorted({b['kind'] for _, b in res})}")

    async def recovered(ck: str, out_dir: str) -> int:
        recovered0 = met.value("serve.recovered")
        srv = DSEServer(Session(cache_dir=None, device=device,
                                resilience=ResilienceConfig(ckpt_dir=ck)),
                        ServeConfig(port=0, exit_on_kill=False,
                                    flight_dir=out_dir))
        t0 = time.perf_counter()
        await srv.start()
        wall = time.perf_counter() - t0
        try:
            n = met.value("serve.recovered") - recovered0
            st, ready = await http_json(host, srv.port, "GET", "/readyz")
            check(n == 16 and st == 200, f"serve: recovered {n}, /readyz "
                  f"{st}")
        finally:
            await srv.stop()
        return wall

    tracer = obs.enable_tracing()
    try:
        asyncio.run(asyncio.wait_for(one_flush(), 900))
        with tempfile.TemporaryDirectory() as tmp:
            asyncio.run(asyncio.wait_for(loadgen_and_drain(tmp), 900))
            ck = os.path.join(tmp, "ckpt")
            try:
                asyncio.run(asyncio.wait_for(killed_drain(ck, tmp), 900))
            finally:
                faultinject.clear()
            wall = asyncio.run(asyncio.wait_for(recovered(ck, tmp), 900))
            check(not os.path.exists(drainmod.pending_path(ck)),
                  "serve: recovery left the pending file")
            rec = json.loads(Path(drainmod.recovered_path(ck))
                             .read_text())["reports"]
            swaps = sum(held_slice("recovered", r) for r in rec)
            log(f"[serve] kill@serve-drain: 16 parked queries persisted, "
                f"the drain died before its flush, the parked requests "
                f"answered timeout; a fresh server recovered all 16 at "
                f"start in {wall:.4f} s, as the JAX package's ({swaps} tied "
                f"swaps){on}")
    finally:
        obs.disable_tracing()
    n_flush = len(tracer.spans("flush"))
    check(n_flush == 3, f"serve: {n_flush} flush spans traced, not 3")


def fp32_ops_per_design(T) -> int:
    """float32 operations of one design in ``csrc/maestro_eval.cu``,
    counted from the source: each add, sub, mul, div, max, trunc and round
    is one and an fma two; 62 outside the case loop (each of the four
    ``floordiv_f`` takes 7: ``exact_fmod``'s division, trunc and fma, then
    subtract, divide and round), one more for an o-coupled egress, 21 per
    case row.  The sign corrections never fire on this sweep's positive
    operands, and its quotients stay inside ``exact_fmod``'s domain.
    Integer operations are left out: the card's published rates give none
    for int32 outside the tensor cores."""
    return 62 + int(T.o_coupled_spatial) + 21 * len(T.cases)


def kernel_record(tables, device, launches: int, max_abs_err: float,
                  name: str, sweep_ms: float) -> dict:
    """Timing of one 2^24-design chunk: the kernel, its plain version and
    the bound, on the table with the most case rows; the share of the bound
    reached, and the sweep's ``sweep_ms`` split into its launches (their
    count times this kernel time) and the rest (the harness's argmax and
    indexing, and the wrapper's host time)."""
    from repro_torch.kernels.maestro_eval import (closed_form_features,
                                                  maestro_eval)
    op, df, T = max(tables, key=lambda t: len(t[2].cases))
    pes, bw = sweep_inputs(device)
    n = pes.numel()
    ms = time_ms(lambda: maestro_eval(pes, bw, tables=T), 20)
    plain_ms = time_ms(lambda: closed_form_features(pes, bw, T), 3)
    mem_bw = BW_PCIE if "PCIe" in name else BW_SXM
    bytes_ms = n * BYTES_PER_DESIGN / mem_bw * 1e3
    ops_ms = n * fp32_ops_per_design(T) / PEAK_FP32 * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    kernels_ms = launches * ms
    log(f"[kernel] maestro_eval on {op.name} {df.name} ({len(T.cases)} "
        f"case rows), {n} designs: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms: "
        f"{bound_ms / ms:.4f} of the bound; sweep {sweep_ms:.3f} ms = "
        f"{launches} x kernel {kernels_ms:.3f} ms + the rest "
        f"{sweep_ms - kernels_ms:.3f} ms")
    return {
        "name": "maestro_eval", "route": "cuda",
        "source": "src/repro_torch/kernels/maestro_eval/csrc/maestro_eval.cu",
        "replaces": "src/repro/kernels/maestro_eval/maestro_eval.py:115",
        "launches": launches, "max_abs_err": max_abs_err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
    }


# ----------------------------------------------------------------------
# the LLM path: flash_attention, llama3-8b forward and serving
# ----------------------------------------------------------------------

def qkv(shape, dtype, device, seed: int = 0):
    B, Sq, Sk, Hq, Hkv, D, _ = shape
    g = torch.Generator(device=device).manual_seed(seed)
    return tuple(torch.randn(s, generator=g, device=device).to(dtype)
                 for s in ((B, Sq, Hq, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D)))


def phase_flash_vs_plain(device) -> float:
    """The kernel against ``attention_ref`` on the same inputs, at every
    tile the kernel for (dtype, D) takes; returns the largest absolute
    error over all shapes."""
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention)
    from repro_torch.kernels.flash_attention.flash_attention import tiles
    worst = 0.0
    cases = [(s, dt) for dt in (torch.float32, torch.bfloat16)
             for s in FLASH_SHAPES] + [(LLM_SHAPE, torch.bfloat16)]
    for shape, dt in cases:
        causal, D = shape[-1], shape[-2]
        q, k, v = qkv(shape, dt, device)
        want = attention_ref(q, k, v, causal=causal).float()
        tol = FLASH_TOL[dt]
        for blk_q, blk_k in tiles(dt, D):
            got = flash_attention(q, k, v, causal=causal, blk_q=blk_q,
                                  blk_k=blk_k).float()
            sync(device)
            check(bool(torch.isfinite(got).all()), f"flash {shape} {dt}: "
                  "non-finite output")
            d = (got - want).abs()
            bad = int((d > tol + tol * want.abs()).sum())
            a = float(d.max())
            r = float((d / want.abs().clamp(min=1e-6)).max())
            worst = max(worst, a)
            log(f"[flash-vs-plain] {shape} {str(dt)[6:]} tile "
                f"({blk_q}, {blk_k}): max abs err {a:.3g}, max rel err "
                f"{r:.3g}, beyond atol=rtol={tol}: {bad}")
            check(bad == 0, f"flash {shape} {dt} ({blk_q}, {blk_k}): {bad} "
                  f"elements beyond {tol}")
            del got, d
        del q, k, v, want
    return worst


def llm_batch(cfg, device, B: int, S: int, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy(rng.integers(0, cfg.vocab, (B, S))
                                .astype(np.int32)).to(device)
            for k in ("tokens", "labels")}


def phase_llm_forward(cfg, params, device, kernel, B: int = 2,
                      S: int = 2048):
    """``loss_fn`` at (B, S): once to warm up, then once timed, the launch
    count of ``kernel`` (the wrapper the path runs) set to 0 just before
    the timed forward and read just after.  Returns (loss, seconds,
    launches)."""
    from repro_torch.models import registry
    batch = llm_batch(cfg, device, B, S)
    with torch.no_grad():
        registry.loss_fn(params, batch, cfg)
        sync(device)
        kernel.launches = 0
        t0 = time.perf_counter()
        loss = float(registry.loss_fn(params, batch, cfg))
        sync(device)
        seconds = time.perf_counter() - t0
        launches = kernel.launches
    log(f"[llm-forward] {cfg.name} {cfg.n_layers} layers loss_fn B={B} "
        f"S={S}: loss {loss:.6g} (ln vocab {np.log(cfg.vocab):.6g}), "
        f"{seconds:.4f} s, {B * S / seconds:.6g} tokens/s, "
        f"{kernel.__name__} launches {launches}")
    return loss, seconds, launches


def phase_serving(cfg, params, device, kernel, n_requests: int = 6,
                  slots: int = 4, max_len: int = 1024, max_new: int = 32,
                  prompt_lens=(128, 512)):
    """``ServeEngine`` end to end; prefill time is the time spent in the
    engine's whole-batch (re-)prefills, decode time the rest of the run.
    ``kernel``'s launches are counted apart in the prefills and in the
    decode steps.  Returns (finished requests, launches in each prefill,
    launches in all decode steps, width of each prefill)."""
    from repro_torch.inference import ServeEngine

    class Timed(ServeEngine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.prefill_s = 0.0
            self.prefills = self.steps = 0
            self.prefill_launches, self.widths = [], []

        def _prefill_slot(self, slot, req):
            self.widths.append(max(
                [1] + [len(r.prompt) + len(r.generated) for r in
                       self.active[:slot] + [req] + self.active[slot + 1:]
                       if r is not None]))
            sync(device)
            before = kernel.launches
            t0 = time.perf_counter()
            super()._prefill_slot(slot, req)
            sync(device)
            self.prefill_s += time.perf_counter() - t0
            self.prefills += 1
            self.prefill_launches.append(kernel.launches - before)

        def step(self):
            self.steps += 1
            return super().step()

    rng = np.random.default_rng(0)
    lens = rng.integers(prompt_lens[0], prompt_lens[1] + 1, n_requests)
    eng = Timed(cfg, params, slots=slots, max_len=max_len, device=device)
    for n in lens:
        eng.submit(rng.integers(0, cfg.vocab, n), max_new=max_new)
    kernel.launches = 0
    t0 = time.perf_counter()
    done = eng.run()
    sync(device)
    wall = time.perf_counter() - t0
    decode_launches = kernel.launches - sum(eng.prefill_launches)
    decode_s = wall - eng.prefill_s
    n_tok = sum(len(r.generated) for r in done)
    log(f"[serving] {cfg.name}: {len(done)} requests (prompts "
        f"{sorted(int(n) for n in lens)}) through {slots} slots in "
        f"{eng.steps} steps, {wall:.4f} s: {eng.prefills} prefills "
        f"{eng.prefill_s:.4f} s (widths {eng.widths}), decode "
        f"{decode_s:.4f} s for {n_tok} tokens = {n_tok / decode_s:.6g} "
        f"tokens/s; {kernel.__name__} launches per prefill "
        f"{eng.prefill_launches}, in decode {decode_launches}")
    for r in sorted(done, key=lambda r: r.uid):
        check(len(r.generated) == max_new and all(
            0 <= t < cfg.vocab for t in r.generated),
            f"request {r.uid}: {len(r.generated)} tokens, not {max_new}")
    check(sorted(r.uid for r in done) == list(range(n_requests)),
          f"serving finished {len(done)} of {n_requests} requests")
    return done, eng.prefill_launches, decode_launches, eng.widths


def profile_llm(cfg, params, device, kernel: str, B: int = 2, S: int = 2048,
                slots: int = 4, prompt: int = 512, steps: int = 4) -> None:
    """Where the time goes: one ``loss_fn`` forward at (B, S), and
    ``steps`` decode steps of a ``slots``-wide batch after a prefill of
    ``prompt`` tokens, each step ending in the host read of the next
    tokens as the engine's does; the device kernels named ``kernel*``
    apart."""
    from repro_torch.models import registry
    rng = np.random.default_rng(2)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (B, S))
                                 .astype(np.int32)).to(device)
             for k in ("tokens", "labels")}
    with torch.no_grad():
        profile_call(lambda: registry.loss_fn(params, batch, cfg),
                     f"{cfg.name} loss_fn B={B} S={S}", device, kernel)
        del batch
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (slots, prompt))
                                .astype(np.int32)).to(device)
        logits, cache = registry.prefill(params, {"tokens": toks}, cfg,
                                         prompt + steps + 1)
        tok0 = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)

        def decode():
            c, tok = cache, tok0
            for _ in range(steps):
                logits, c = registry.decode_step(params, {"tokens": tok}, c,
                                                 cfg)
                tok = torch.argmax(logits[:, -1], -1)[:, None].to(
                    torch.int32)
                tok.cpu()
        profile_call(decode, f"{cfg.name} {steps} decode steps, batch "
                     f"{slots}, cache {prompt}", device, kernel)


def phase_prefill_vs_decode(cfg, params, device, S: int = 128,
                            rel_tol: float = 5e-2) -> float:
    """Decoding token S-1 with the cache of the prefix against the
    full-sequence forward at S-1 (``tests/test_archs_smoke.py``'s check),
    at full width in ``cfg.dtype``: relative L2 error of the logits (held
    to ``rel_tol``), and the argmax.  Returns the relative error."""
    from repro_torch.models import registry, transformer
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (1, S))
                            .astype(np.int32)).to(device)
    with torch.no_grad():
        batch = {"tokens": toks}
        full, _ = transformer.forward(params, batch, cfg, cache=(
            transformer.empty_cache(params, batch, cfg, train=False,
                                    max_len=S + 4)))
        _, cache = registry.prefill(params, {"tokens": toks[:, :S - 1]}, cfg,
                                    S + 4)
        step, _ = registry.decode_step(params, {"tokens": toks[:, S - 1:]},
                                       cache, cfg)
    a, b = full[0, -1].float(), step[0, -1].float()
    rel = float((a - b).norm() / a.norm())
    same = int(a.argmax()) == int(b.argmax())
    log(f"[prefill-vs-decode] {cfg.name} {str(cfg.dtype)[6:]} S={S}: logits "
        f"rel L2 err {rel:.4g} (limit {rel_tol}), argmax equal {same}")
    check(rel <= rel_tol and same, "prefill-then-decode "
          "disagrees with the full-sequence forward")
    return rel


def flash_record(device, launches: int, max_abs_err: float,
                 name: str) -> dict:
    """Kernel (at each of its tiles; the default's time is ``ms``), plain
    version and SDPA times at the LLM path's shape, and the bound: the
    larger of the causal product's operations over the bf16 tensor-core
    peak and the bytes read and written once over the memory rate."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention)
    from repro_torch.kernels.flash_attention.flash_attention import tiles
    B, Sq, Sk, Hq, Hkv, D, causal = LLM_SHAPE
    q, k, v = qkv(LLM_SHAPE, torch.bfloat16, device)
    by_tile = {t: time_ms(lambda: flash_attention(
        q, k, v, causal=causal, blk_q=t[0], blk_k=t[1]), 20)
        for t in tiles(torch.bfloat16, D)}
    tile = tiles(torch.bfloat16, D)[0]
    ms = by_tile[tile]
    plain_ms = time_ms(lambda: attention_ref(q, k, v, causal=causal), 3)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal, enable_gqa=True), 20)
    pairs = Sq * (Sq + 1) // 2 if causal else Sq * Sk  # (q, k) pairs kept
    flops = 4 * B * Hq * D * pairs                      # q.k and p.v
    nbytes = 2 * (2 * B * Sq * Hq * D + 2 * B * Sk * Hkv * D)
    mem_bw = BW_PCIE if "PCIe" in name else BW_SXM
    ops_ms = flops / PEAK_BF16 * 1e3
    bytes_ms = nbytes / mem_bw * 1e3
    for t, t_ms in by_tile.items():
        log(f"[kernel] flash_attention {LLM_SHAPE} bf16 tile {t}: "
            f"{t_ms:.4f} ms ({flops / t_ms / 1e9:.6g} TFLOP/s)")
    log(f"[kernel] flash_attention {LLM_SHAPE} bf16: kernel {ms:.4f} ms "
        f"at the default tile {tile}, plain {plain_ms:.4f} ms, SDPA "
        f"{library_ms:.4f} ms, bound {max(ops_ms, bytes_ms):.4f} ms "
        f"(operations {ops_ms:.4f}, bytes {bytes_ms:.4f}): "
        f"{max(ops_ms, bytes_ms) / ms:.4f} of the bound")
    return {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:78",
        "design": f"wgmma bf16 (P rounded to bf16), TMA, 2-stage K/V ring, "
                  f"BQ={tile[0]}, BK={tile[1]}; float32 on the SIMT kernel",
        "launches": launches, "max_abs_err": max_abs_err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": library_ms,
    }


# ----------------------------------------------------------------------
# the RWKV-6 path: linear_scan, rwkv6-1.6b forward and serving
# ----------------------------------------------------------------------

def scan_inputs(shape, dtype, device, seed: int = 0, state: bool = False,
                decay: float = 0.2):
    """r, k, v ~ N(0, 1) in ``dtype``; log_w = -|N(0, 1)| * ``decay`` (0.2
    as ``tests/test_kernels.py`` draws it) and u ~ N(0, 1) in float32;
    state0 N(0, 1) or zeros."""
    B, T, H, K, V, _, use_u, _ = shape
    g = torch.Generator(device=device).manual_seed(seed)

    def n(*s):
        return torch.randn(s, generator=g, device=device)
    r, k, v = (n(B, T, H, d).to(dtype) for d in (K, K, V))
    lw = -n(B, T, H, K).abs() * decay
    u = n(H, K) if use_u else None
    s0 = n(B, H, K, V) if state else torch.zeros(B, H, K, V, device=device)
    return r, k, v, lw, u, s0


def scan_f64(r, k, v, log_w, u, state0, chunk: int, post: bool):
    """``linear_scan_ref``'s chunked algebra (``models/ssm.py``
    ``chunked_linear_attn``) in float64, on the inputs cast to float64; the
    clamp at the float32 -60/c the kernel and the plain version use."""
    r, k, v, lw, s = (t.double() for t in (r, k, v, log_w, state0))
    T = r.shape[1]
    c = min(chunk, T)
    lw = lw.clamp(float(np.float32(-60.0 / c)), 0.0)
    idx = torch.arange(c, device=r.device)
    tri = (idx[:, None] >= idx[None, :]) if post else (
        idx[:, None] > idx[None, :])
    outs = []
    for n in range(T // c):
        sl = slice(n * c, (n + 1) * c)
        rb, kb, vb, lwb = r[:, sl], k[:, sl], v[:, sl], lw[:, sl]
        P = torch.cumsum(lwb, dim=1)
        q_eff = rb * torch.exp(P if post else P - lwb)
        A = torch.einsum("bihk,bjhk->bhij", q_eff, kb * torch.exp(-P)) * tri
        if u is not None:
            A = A + torch.diag_embed(torch.einsum(
                "bchk,hk,bchk->bch", rb, u.double(), kb).transpose(1, 2))
        outs.append(torch.einsum("bchk,bhkv->bchv", q_eff, s)
                    + torch.einsum("bhij,bjhv->bihv", A, vb))
        s = s * torch.exp(P[:, -1])[..., None] + torch.einsum(
            "bchk,bchv->bhkv", kb * torch.exp(P[:, -1:] - P), vb)
    return torch.cat(outs, dim=1), s


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.double() - want).norm() / want.norm())


def phase_scan_vs_plain(device) -> float:
    """The kernel against ``linear_scan_ref`` on the same inputs, o and the
    final state; then both against the float64 scan at rwkv6's shape and
    at ``HANDOFF_SCAN``. Returns the largest absolute error against the
    plain version over all shapes."""
    from repro_torch.kernels.linear_scan import linear_scan, linear_scan_ref
    worst = 0.0
    cases = [(s, dt, False) for dt in (torch.float32, torch.bfloat16)
             for s in SCAN_SHAPES] + [
        (SCAN_ODD, torch.float32, True), (SCAN_ODD, torch.bfloat16, True),
        (RWKV_SCAN, torch.float32, False),
        (HANDOFF_SCAN, torch.float32, True),
        (MAMBA_SCAN, torch.float32, False)] + [
        (s, torch.float32, False) for s in SERVE_SCANS] + [
        (SERVE_SCANS[-1], torch.float32, True)]
    for shape, dt, state in cases:
        *_, post, _, chunk = shape
        decay = WEAK_DECAY if shape == HANDOFF_SCAN else 0.2
        r, k, v, lw, u, s0 = scan_inputs(shape, dt, device, state=state,
                                         decay=decay)
        o, s = linear_scan(r, k, v, lw, u, s0, chunk=chunk, post_update=post)
        sync(device)
        want_o, want_s = linear_scan_ref(r, k, v, lw, u=u, state0=s0,
                                         chunk=chunk, post_update=post)
        check(o.dtype == dt and s.dtype == torch.float32,
              f"linear_scan {shape} {dt}: output dtypes {o.dtype}, {s.dtype}")
        tol = SCAN_TOL[dt]
        for name, got, want in (("o", o.float(), want_o), ("state", s,
                                                           want_s)):
            check(bool(torch.isfinite(got).all()), f"linear_scan {shape} "
                  f"{dt}: non-finite {name}")
            d = (got - want).abs()
            bad = int((d > tol + tol * want.abs()).sum())
            a = float(d.max())
            worst = max(worst, a)
            log(f"[scan-vs-plain] {shape} {str(dt)[6:]}{' state0' * state} "
                f"{name}: max abs err {a:.3g}, max |want| "
                f"{float(want.abs().max()):.3g}, beyond atol=rtol={tol}: "
                f"{bad}")
            check(bad == 0, f"linear_scan {shape} {dt} {name}: {bad} "
                  f"elements beyond {tol}")
        if shape in (RWKV_SCAN, HANDOFF_SCAN):
            # float32 against float64: the kernel within twice the plain
            # version's own error (1e-6 at least), on o and the state
            exact_o, exact_s = scan_f64(r, k, v, lw, u, s0, chunk, post)
            if shape == HANDOFF_SCAN:
                # each chunk alone, from a zero state: o less that is what
                # the hand-off carries in
                B, T, H, K, V = shape[:5]
                alone = scan_f64(*(t.reshape(B * T // chunk, chunk, H, -1)
                                   for t in (r, k, v, lw)), u,
                                 torch.zeros(B * T // chunk, H, K, V,
                                             device=device), chunk, post)[0]
                carried = exact_o - alone.reshape(exact_o.shape)
                share = float(carried.norm() / exact_o.norm())
                log(f"[scan-vs-f64] {shape}: the handed-off state's share "
                    f"of o, rel L2 {share:.3g}")
            for name, got, plain, exact in (("o", o, want_o, exact_o),
                                            ("state", s, want_s, exact_s)):
                e_k, e_p = rel_l2(got, exact), rel_l2(plain, exact)
                lim = max(1e-6, 2 * e_p)
                log(f"[scan-vs-f64] {shape} {name}: kernel rel L2 err "
                    f"{e_k:.3g}, plain {e_p:.3g} (limit {lim:.3g})")
                check(e_k <= lim, f"linear_scan {shape} {name}: {e_k:.3g} "
                      f"rel L2 from the float64 scan, above {lim:.3g}")
            del exact_o, exact_s
        del r, k, v, lw, u, s0, o, s, want_o, want_s
    return worst


def scan_work(shape) -> tuple[int, int, int]:
    """(least float32 operations, the chunked form's, bytes) of the scan at
    ``shape`` with float32 inputs.  Least: the same clamped recurrence run
    token by token, per (b, t, h) exp(log_w) (K), S = w*S + k v^T (3KV)
    and r.S (2KV), with the bonus r.(u*k) v (3K + 2V) when u is given.
    Chunked, the Pallas kernel's form at chunk c: per (b, h, chunk) the
    inter term q_eff S (2cKV), A over the lower triangle with its diagonal
    (K c(c+1)), A v (V c(c+1)), the state update (2cKV + KV) and the
    elementwise work (cumsum, two exps, the factors: 6cK; the bonus: 3cK;
    exp(P_last): K); ``csrc/linear_scan.cu`` runs the same form on tiles
    of up to 64 rows (``scan_passes``).  Bytes: r, k, log_w, v read once,
    o written once, u, state0 read and the state written."""
    B, T, H, K, V, _, use_u, c = shape
    least = B * T * H * (5 * K * V + K + ((3 * K + 2 * V) if use_u else 0))
    tri = c * (c + 1)
    per_chunk = (4 * c * K * V + K * tri + V * tri + K * V
                 + (9 if use_u else 6) * c * K + K)
    chunked = B * H * (T // c) * per_chunk
    nbytes = 4 * (3 * B * T * H * K + 2 * B * T * H * V
                  + (H * K if use_u else 0) + 2 * B * H * K * V)
    return least, chunked, nbytes


def scan_passes(shape) -> list[tuple[str, int, int]]:
    """(name, blocks, float32 products) of each of the kernel's three
    passes at ``shape``, per tile of n <= 64 rows (``T/c * ceil(c/64)``
    tiles, none across chunks): the state pass 2nKV, the hand-off 2KV, the
    output pass 2nKV + (K + V) n(n+1)."""
    B, T, H, K, V, _, _, c = shape
    nvs, nq = -(-V // 64), -(-c // 64)
    rows = [min(64, c - 64 * t) for t in range(nq)] * (T // c)
    bh = B * H
    return [("state", bh * len(rows) * nvs,
             bh * sum(2 * n * K * V for n in rows)),
            ("hand-off", bh * -(-K * V // 256), bh * len(rows) * 2 * K * V),
            ("output", bh * len(rows) * nvs,
             bh * sum(2 * n * K * V + (K + V) * n * (n + 1) for n in rows))]


def scan_record(device, launches: int, max_abs_err: float,
                name: str) -> dict:
    """Kernel (and each of its passes) and plain version at rwkv6-1.6b's
    shape, and the bound."""
    from repro_torch.kernels.linear_scan import linear_scan, linear_scan_ref
    from repro_torch.kernels.linear_scan.linear_scan import (_library,
                                                             launch_args)
    *_, post, _, chunk = RWKV_SCAN
    r, k, v, lw, u, s0 = scan_inputs(RWKV_SCAN, torch.float32, device)
    ms = time_ms(lambda: linear_scan(r, k, v, lw, u, s0, chunk=chunk,
                                     post_update=post), 20)
    plain_ms = time_ms(lambda: linear_scan_ref(
        r, k, v, lw, u=u, state0=s0, chunk=chunk, post_update=post), 3)
    flops, chunked, nbytes = scan_work(RWKV_SCAN)
    mem_bw = BW_PCIE if "PCIe" in name else BW_SXM
    ops_ms = flops / PEAK_FP32 * 1e3
    bytes_ms = nbytes / mem_bw * 1e3
    log(f"[kernel] linear_scan {RWKV_SCAN} float32: kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, bound {max(ops_ms, bytes_ms):.4f} ms "
        f"(operations {ops_ms:.4f}: {flops / 1e9:.6g} GFLOP token by token "
        f"at 67 TFLOP/s float32; bytes {bytes_ms:.4f}: {nbytes / 1e6:.6g} "
        f"MB); the chunked form's {chunked / 1e9:.6g} GFLOP would take "
        f"{chunked / PEAK_FP32 * 1e3:.4f} ms ({chunked / ms / 1e9:.6g} "
        f"TFLOP/s done); {max(ops_ms, bytes_ms) / ms:.4f} of the bound; "
        f"launches on the main path {launches}")
    # each pass alone, on the scratch the whole scan left
    _, _, args, keep = launch_args(r, k, v, lw, u, s0, chunk, post)
    lib = _library()
    for which, (pname, blocks, pflops) in enumerate(scan_passes(RWKV_SCAN)):
        p_ms = time_ms(lambda: lib.linear_scan_pass(which, *args), 20)
        log(f"[kernel] linear_scan {pname} pass: {p_ms:.4f} ms in {blocks} "
            f"blocks of 256 threads, {pflops / 1e9:.6g} GFLOP of products, "
            f"{pflops / p_ms / 1e6:.6g} GFLOP/s")
    del keep
    return {
        "name": "linear_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/linear_scan/csrc/linear_scan.cu",
        "replaces": "src/repro/kernels/linear_scan/linear_scan.py:84",
        "design": "float32 SIMT: state pass, tile-to-tile hand-off, output "
                  "pass, per tile of up to 64 rows",
        "launches": launches, "max_abs_err": max_abs_err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": None,
    }


def top2_gap(logits: torch.Tensor) -> list[float]:
    """Per row, the largest logit less the second largest."""
    top = logits.topk(2, dim=-1).values
    return [float(g) for g in top[:, 0] - top[:, 1]]


def phase_plain_route(cfg, params, device, module, attr: str, kernel, plain,
                      B: int = 2, S: int = 2048, rel_tol: float = 1e-3,
                      l2_tol: float | None = None,
                      need_argmax: bool = True) -> None:
    """The forward on the card with ``module.attr`` (the kernel's wrapper
    as the model calls it) forced onto the plain version ``plain`` (here
    only: the library has no such switch) against the kernel route: the
    loss within ``rel_tol`` relative; the last logits' relative L2 error
    (held to ``l2_tol`` where given), both routes' argmaxes and top-2 gaps
    printed and, with ``need_argmax``, the argmaxes equal."""
    from repro_torch.models import registry, transformer
    batch = llm_batch(cfg, device, B, S)
    tokens = {"tokens": batch["tokens"]}

    def run():
        loss = float(registry.loss_fn(params, batch, cfg))
        logits, _ = transformer.forward(params, tokens, cfg, cache=(
            transformer.empty_cache(params, tokens, cfg, train=True)))
        return loss, logits[:, -1].float()

    with torch.no_grad():
        loss_k, last_k = run()
        wrapper = getattr(module, attr)
        setattr(module, attr, plain)
        before = kernel.launches
        try:
            loss_p, last_p = run()
        finally:
            setattr(module, attr, wrapper)
        check(kernel.launches == before, "the plain route launched the "
              "kernel")
    rel = abs(loss_k - loss_p) / abs(loss_p)
    l2 = float((last_k - last_p).norm() / last_p.norm())
    arg_k, arg_p = last_k.argmax(-1).tolist(), last_p.argmax(-1).tolist()
    same = arg_k == arg_p
    log(f"[plain-route] {cfg.name} {str(cfg.dtype)[6:]} loss_fn B={B} "
        f"S={S} with {attr} -> {plain.__name__}: kernel route loss "
        f"{loss_k:.6g}, plain route {loss_p:.6g}, rel err {rel:.3g} (limit "
        f"{rel_tol}); last logits rel L2 err {l2:.3g}"
        f"{'' if l2_tol is None else f' (limit {l2_tol})'}; argmax kernel "
        f"{arg_k}, plain {arg_p}, equal {same}"
        f"{'' if need_argmax else ' (not required)'}; top-2 gap kernel "
        f"{top2_gap(last_k)}, plain {top2_gap(last_p)}")
    check(rel <= rel_tol and (l2_tol is None or l2 <= l2_tol)
          and (same or not need_argmax), "the kernel route disagrees with "
          "the plain route")


# ----------------------------------------------------------------------
# training: the flash attention backward, olmo-1b train steps
# ----------------------------------------------------------------------

# flash_attention_bwd vs attention_bwd_ref, rel L2 of dq, dk, dv: float32
# sums in another order (dq's atomics in a varying one); bf16 rounds the
# outputs to 8 mantissa bits
BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# (B, S, Hq, Hkv, D, causal): ragged heads, every head dim, both masks;
# S = 192 on the SIMT forward (D = 32: the wgmma one's tiles are 128)
BWD_SHAPES = [(1, 128, 3, 1, 16, True), (2, 128, 6, 2, 64, False),
              (1, 192, 5, 5, 32, True), (1, 256, 4, 2, 128, False)]
OLMO_BWD = (2, 2048, 16, 16, 128, True)    # olmo-1b, a train step's shape
LLAMA_BWD = (2, 2048, 32, 8, 128, True)    # llama3-8b's
TRAIN_SHAPE = (2, 2048)                    # olmo-1b train steps: B, S
TRAIN_STEPS = 3


def bwd_inputs(shape, dtype, device, seed: int = 0):
    """q, k, v, the forward kernel's o and lse, and do ~ N(0, 1)."""
    from repro_torch.kernels.flash_attention import flash_attention_with_lse
    B, S, Hq, Hkv, D, causal = shape
    q, k, v = qkv((B, S, S, Hq, Hkv, D, causal), dtype, device, seed)
    g = torch.Generator(device=device).manual_seed(seed + 1)
    do = torch.randn(q.shape, generator=g, device=device).to(dtype)
    o, lse = flash_attention_with_lse(q, k, v, causal=causal)
    return q, k, v, o, do, lse


# the forward kernel's lse against attention_ref's: float32 sums in another
# order, the wgmma kernel in base 2 (exp2, log2, then times ln 2)
LSE_TOL = 1e-5


def phase_flash_bwd_vs_plain(device) -> float:
    """The backward kernel against ``attention_bwd_ref`` on the same
    inputs (o and lse from the forward kernel; the plain version computes
    its own lse, and the kernel's is held against it first), rel L2 of
    dq, dk and dv, at ragged small shapes and olmo-1b's and llama3-8b's,
    float32 and bf16; for bf16 also against the float32 gradient of the
    bf16 values with the float32 o (the wgmma forward's o has P rounded
    to bf16: held to the same 2e-2).  Returns the largest absolute error
    against the plain version."""
    from repro_torch.kernels.flash_attention import (attention_bwd_ref,
                                                     attention_ref,
                                                     flash_attention_bwd)
    from repro_torch.kernels.flash_attention.flash_attention import (
        bwd_tile)
    worst = 0.0
    cases = [(s, dt) for s in BWD_SHAPES + [OLMO_BWD]
             for dt in (torch.float32, torch.bfloat16)] + [
        (LLAMA_BWD, torch.bfloat16)]
    for shape, dt in cases:
        causal = shape[-1]
        q, k, v, o, do, lse = bwd_inputs(shape, dt, device)
        _, lse_ref = attention_ref(q, k, v, causal=causal, return_lse=True)
        lse_err = float(((lse - lse_ref).abs() /
                         (LSE_TOL + LSE_TOL * lse_ref.abs())).max())
        got = flash_attention_bwd(q, k, v, o, do, lse=lse, causal=causal)
        sync(device)
        want = attention_bwd_ref(q, k, v, o, do, causal=causal)
        errs = [rel_l2(g, w.double()) for g, w in zip(got, want)]
        ok = all(torch.isfinite(g).all() for g in got)
        worst = max([worst] + [float((g.float() - w.float()).abs().max())
                               for g, w in zip(got, want)])
        route = "wgmma" if bwd_tile(dt, shape[4])[1] == 128 else "SIMT"
        line = (f"[flash-bwd-vs-plain] {shape} {str(dt)[6:]} ({route}): "
                f"lse max abs err {float((lse - lse_ref).abs().max()):.3g} "
                f"(atol=rtol={LSE_TOL}); rel L2 dq {errs[0]:.3g}, dk "
                f"{errs[1]:.3g}, dv {errs[2]:.3g} (limit {BWD_TOL[dt]})")
        del want, lse_ref
        if dt == torch.bfloat16:
            qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
            o32 = attention_ref(qf, kf, vf, causal=causal)
            exact = attention_bwd_ref(qf, kf, vf, o32, dof, causal=causal)
            e32 = [rel_l2(g, w.double()) for g, w in zip(got, exact)]
            line += (f"; against float32 formulas with the float32 o: dq "
                     f"{e32[0]:.3g}, dk {e32[1]:.3g}, dv {e32[2]:.3g}")
            errs += e32
            del qf, kf, vf, dof, o32, exact
        log(line)
        check(lse_err <= 1.0, f"flash forward {shape} {dt}: lse beyond "
              f"atol=rtol={LSE_TOL} of attention_ref's")
        check(ok and max(errs) <= BWD_TOL[dt], f"flash backward {shape} "
              f"{dt}: rel L2 {errs} beyond {BWD_TOL[dt]}")
        del q, k, v, o, do, lse, got
        torch.cuda.empty_cache()
    return worst


def flash_bwd_times(shape, device, name: str) -> dict:
    """The backward kernel (and each of its kernels' device time, the
    delta pass apart), its plain version
    and SDPA's backward (through autograd, on the same inputs) at
    ``shape`` in bf16, and the bound: 2.5 x the causal forward's
    operations over the bf16 tensor-core peak, or the bytes of q, k, v,
    o, do and lse read and dq, dk, dv written once over the memory rate,
    whichever is larger; then the forward kernel with and without its lse
    store, in turns."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (
        attention_bwd_ref, flash_attention, flash_attention_bwd,
        flash_attention_with_lse)
    B, S, Hq, Hkv, D, causal = shape
    q, k, v, o, do, lse = bwd_inputs(shape, torch.bfloat16, device, seed=5)
    ms = time_ms(lambda: flash_attention_bwd(q, k, v, o, do, lse=lse,
                                             causal=causal), 10)
    parts = device_ms_by_kernel(lambda: flash_attention_bwd(
        q, k, v, o, do, lse=lse, causal=causal), 3)
    plain_ms = time_ms(lambda: attention_bwd_ref(q, k, v, o, do,
                                                 causal=causal), 3)
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True)
                  for t in (q, k, v))
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                         enable_gqa=True)
    dot = do.transpose(1, 2).contiguous()
    library_ms = time_ms(lambda: torch.autograd.grad(
        out, (qt, kt, vt), dot, retain_graph=True), 10)
    del out, qt, kt, vt, dot
    fwd = [time_ms(lambda: flash_attention(q, k, v, causal=causal), 20),
           time_ms(lambda: flash_attention_with_lse(q, k, v, causal=causal),
                   20)]
    fwd += [time_ms(lambda: flash_attention_with_lse(q, k, v, causal=causal),
                    20),
            time_ms(lambda: flash_attention(q, k, v, causal=causal), 20)]
    pairs = S * (S + 1) // 2 if causal else S * S
    flops = 2.5 * 4 * B * Hq * D * pairs
    nbytes = 2 * (3 * 2 * B * S * Hq * D + 2 * 2 * B * S * Hkv * D) + \
        4 * B * Hq * S
    mem_bw = BW_PCIE if "PCIe" in name else BW_SXM
    ops_ms, bytes_ms = flops / PEAK_BF16 * 1e3, nbytes / mem_bw * 1e3
    bound = max(ops_ms, bytes_ms)
    log(f"[kernel] flash_attention_bwd {shape} bf16: kernel {ms:.4f} ms "
        f"({flops / ms / 1e9:.6g} TFLOP/s counted as 2.5 x the forward), "
        f"plain "
        f"{plain_ms:.4f} ms, SDPA backward {library_ms:.4f} ms, bound "
        f"{bound:.4f} ms (operations {ops_ms:.4f}: {flops / 1e9:.6g} GFLOP "
        f"at 989 TFLOP/s; bytes {bytes_ms:.4f}: {nbytes / 1e6:.6g} MB): "
        f"{bound / ms:.4f} of the bound; kernel / SDPA backward "
        f"{ms / library_ms:.4f}")
    log(f"[kernel] flash_attention_bwd {shape} bf16, device time a call by "
        f"kernel (torch.profiler, 3 calls): " + "; ".join(
            f"{t:.4f} ms {n[:60]}" for n, t in parts.items()))
    log(f"[kernel] flash_attention {shape} bf16 forward in turns: without "
        f"lse {fwd[0]:.4f}, {fwd[3]:.4f} ms; writing lse {fwd[1]:.4f}, "
        f"{fwd[2]:.4f} ms")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound,
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def device_ms_by_kernel(fn, calls: int) -> dict:
    """Device milliseconds a call of ``fn`` by kernel name (the wrapper's
    memsets and casts included), from ``torch.profiler`` over ``calls``
    calls after one warm-up: a kernel of a few microseconds timed alone by
    CUDA events around Python calls reads the host's launch rate."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            out[e.name] = out.get(e.name, 0.0) + \
                e.time_range.elapsed_us() / 1e3 / calls
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def flash_bwd_record(device, launches: int, max_abs_err: float,
                     name: str) -> dict:
    """Times at llama3-8b's shape (logged) and at olmo-1b's, the train
    steps' own shape (recorded)."""
    flash_bwd_times(LLAMA_BWD, device, name)
    t = flash_bwd_times(OLMO_BWD, device, name)
    return {
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention_bwd.cu",
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:78",
        "design": "no TPU counterpart (XLA's gradient of the forward): a "
                  "delta pass, then bf16 at D = 64, 128 on wgmma fed by TMA "
                  "(128 keys a block in two warpgroups, K/V resident, Q/dO "
                  "in a 2-stage ring, lse from the forward, P and dS in "
                  "bf16, dK/dV in registers, dQ by float2 atomics); "
                  "float32 SIMT otherwise; times at olmo-1b's "
                  f"{OLMO_BWD}",
        "launches": launches, "max_abs_err": max_abs_err, **t,
    }


def tree_items(tree, prefix: str = ""):
    """(path, leaf) of a nested dict, keys sorted (the leaves' order)."""
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from tree_items(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", tree[k]


def phase_train(device, card: str = "", cfg=None):
    """olmo-1b at full width and depth (16 layers, d_model 2048, vocab
    50304, bf16) from seed 0: ``TRAIN_STEPS`` steps of ``make_train_step``
    (default AdamW, full remat) at ``TRAIN_SHAPE`` through
    ``FaultTolerantLoop``, checkpoints off at this size (a period past the
    run).  Every step: finite loss and grad_norm, 2 x 16 forward and 16
    backward flash launches (each layer's forward runs again in the
    backward).  Tokens/s per step (the first includes warm-up); peak
    device memory; then one more step under ``torch.profiler``.  Returns
    (params, launches of the backward, of the forward)."""
    import tempfile
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import REGISTRY
    from repro_torch.data import batch_for_step
    from repro_torch.ft import FaultTolerantLoop, FTConfig
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.linear_scan import linear_scan
    from repro_torch.kernels.maestro_eval import maestro_eval
    from repro_torch.models.param import count_params
    from repro_torch.models import registry
    from repro_torch.training import (TrainConfig, init_train_state,
                                      make_train_step)
    cfg = cfg or REGISTRY["olmo-1b"]
    B, S = TRAIN_SHAPE
    tc = TrainConfig()
    t1 = time.perf_counter()
    params, opt = init_train_state(cfg, tc, 0, device)
    sync(device)
    log(f"[train] {cfg.name} at full width and depth: "
        f"{count_params(registry.specs(cfg))} parameters drawn on the card "
        f"in {time.perf_counter() - t1:.2f} s, remat {cfg.remat}, "
        f"{str(cfg.dtype)[6:]}")
    step = make_train_step(cfg, tc, device=device)
    steps = []

    def wrapped(state, batch):
        p, o = state
        f0, b0 = flash_attention.launches, flash_attention.bwd_launches
        t0 = time.perf_counter()
        p, o, m = step(p, o, batch)
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])  # waits
        steps.append((time.perf_counter() - t0, loss, gnorm,
                      flash_attention.launches - f0,
                      flash_attention.bwd_launches - b0))
        return (p, o), m

    def batch_fn(i):
        return batch_for_step(i, global_batch=B, seq=S, vocab=cfg.vocab)

    torch.cuda.reset_peak_memory_stats(device)
    with tempfile.TemporaryDirectory() as d:
        loop = FaultTolerantLoop(wrapped, Checkpointer(d, keep=1), FTConfig(
            checkpoint_every=10 ** 9, async_save=False))
        maestro_eval.launches = linear_scan.launches = 0
        flash_attention.launches = flash_attention.bwd_launches = 0
        (params, opt), end = loop.run((params, opt), batch_fn, 0,
                                      TRAIN_STEPS)
        launches = (flash_attention.launches, flash_attention.bwd_launches,
                    maestro_eval.launches, linear_scan.launches)
    peak = torch.cuda.max_memory_allocated(device)
    for i, (wall, loss, gnorm, fl, bl) in enumerate(steps):
        log(f"[train] step {i}: {wall:.4f} s, {B * S / wall:.6g} tokens/s, "
            f"loss {loss:.6g}, grad_norm {gnorm:.6g}, flash_attention "
            f"launches {fl} forward, {bl} backward")
    log(f"[train] {cfg.name} B={B} S={S}: {TRAIN_STEPS} steps through "
        f"FaultTolerantLoop, {loop.restarts} restarts, stragglers "
        f"{loop.straggler_steps}; launches: flash_attention {launches[0]} "
        f"forward, {launches[1]} backward, maestro_eval {launches[2]}, "
        f"linear_scan {launches[3]}; peak device memory "
        f"{peak / 2 ** 30:.3f} GiB; {card}")
    check(end == TRAIN_STEPS and len(steps) == TRAIN_STEPS,
          f"the loop ended at step {end} after {len(steps)} steps")
    check(all(np.isfinite(s[1]) and np.isfinite(s[2]) for s in steps),
          "a train step's loss or grad_norm is not finite")
    check(all(s[3:] == (2 * cfg.n_layers, cfg.n_layers) for s in steps),
          f"flash launches per step {[s[3:] for s in steps]}, not "
          f"({2 * cfg.n_layers}, {cfg.n_layers})")
    check(launches[2:] == (0, 0), "training launched maestro_eval or "
          "linear_scan")
    batch = batch_fn(TRAIN_STEPS)

    def one_step():
        nonlocal params, opt
        params, opt, m = step(params, opt, batch)
        float(m["loss"])
    prof = profile_call(one_step, f"{cfg.name} train step B={B} S={S}",
                        device, "flash_bwd")
    bwd = {n: v for n, v in prof["by_name"].items() if "flash_bwd" in n}
    bwd_us = sum(us for _, us in bwd.values())
    log("[train] the backward's kernels in the profiled step: " + "; ".join(
        f"{us / 1e3:.3f} ms in {c} x {n[:60]}" for n, (c, us) in
        sorted(bwd.items(), key=lambda kv: -kv[1][1])))
    warm = [B * S / s[0] for s in steps[1:]] or [B * S / steps[0][0]]
    log(f"[train] {cfg.name} step: {min(warm):.6g}-{max(warm):.6g} tokens/s "
        f"warm, busy share {prof['busy'] / prof['wall']:.4f} of the "
        f"profiled step ({prof['busy'] / prof['plain_wall']:.4f} of the "
        f"unprofiled step's wall), the backward "
        f"{bwd_us / 1e6 / max(prof['busy'], 1e-12):.4f} of "
        f"busy; PR 25 (H100 80GB HBM3, 700.00 W): 12685.9-13196.2 tokens/s, "
        f"busy share 0.7022-0.8865, the backward 0.2823-0.2827 of busy")
    check(not any("flash_bwd_prep" in n for n in bwd), "the lse pass "
          "(flash_bwd_prep) still runs in the train step")
    del opt
    torch.cuda.empty_cache()
    return cfg, params, launches[1], launches[0]


def phase_train_plain_route(cfg, params, device, loss_tol: float,
                            leaf_tol: float | None = None,
                            norm_tol: float | None = None) -> None:
    """One step's loss and gradients (``registry.loss_fn`` and
    ``torch.autograd.grad``) on the kernel route against the route with
    ``layers.flash_attention`` forced onto ``attention_ref`` under autograd
    (here only), at ``TRAIN_SHAPE``: the loss within ``loss_tol``
    relative; every gradient leaf's rel L2 printed and held to
    ``leaf_tol``, the global norm to ``norm_tol``, where given."""
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention)
    from repro_torch.models import layers, registry
    from repro_torch.optim.adamw import global_norm
    B, S = TRAIN_SHAPE
    batch = llm_batch(cfg, device, B, S, seed=3)
    names = [n for n, _ in tree_items(params)]
    flat = [p for _, p in tree_items(params)]

    def grads():
        loss = registry.loss_fn(params, batch, cfg)
        g = torch.autograd.grad(loss, flat)
        return float(loss.detach()), g

    bwd0 = flash_attention.bwd_launches
    loss_k, g_k = grads()
    check(flash_attention.bwd_launches == bwd0 + cfg.n_layers,
          "the kernel route did not run the backward kernel once a layer")
    wrapper = layers.flash_attention
    layers.flash_attention = attention_ref
    launches = (flash_attention.launches, flash_attention.bwd_launches)
    try:
        loss_p, g_p = grads()
    finally:
        layers.flash_attention = wrapper
    check((flash_attention.launches, flash_attention.bwd_launches)
          == launches, "the plain route launched a flash kernel")
    rel = abs(loss_k - loss_p) / abs(loss_p)
    nk, np_ = float(global_norm(g_k)), float(global_norm(g_p))
    nrel = abs(nk - np_) / np_
    leaf = {n: rel_l2(a, b.double()) for n, a, b in zip(names, g_k, g_p)}
    log(f"[train-plain-route] {cfg.name} {str(cfg.dtype)[6:]} B={B} S={S} "
        f"with flash_attention -> attention_ref: loss kernel {loss_k:.8g}, "
        f"plain {loss_p:.8g}, rel err {rel:.3g} (limit {loss_tol}); "
        f"grad_norm kernel {nk:.8g}, plain {np_:.8g}, rel err {nrel:.3g}"
        f"{'' if norm_tol is None else f' (limit {norm_tol})'}")
    log("[train-plain-route]   rel L2 by leaf: " + ", ".join(
        f"{n} {e:.3g}" for n, e in leaf.items()) +
        ("" if leaf_tol is None else f" (limit {leaf_tol})"))
    check(rel <= loss_tol and (norm_tol is None or nrel <= norm_tol) and
          (leaf_tol is None or max(leaf.values()) <= leaf_tol),
          "the kernel route's training gradients disagree with the plain "
          "route's")


def f32_params(tree) -> dict:
    """A float32 copy of a model's params: leaves that require grad."""
    return {k: f32_params(v) if isinstance(v, dict) else
            v.detach().float().requires_grad_(True) for k, v in tree.items()}


def phase_train_small(device) -> None:
    """(d) a checkpoint round trip of reduced olmo-1b's train state on the
    card (async save, restore onto the card, bit-equal); (e) reduced
    rwkv6-1.6b training on the card raises the documented error (no
    ``linear_scan`` backward kernel: ROADMAP queue 2)."""
    import tempfile
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import REGISTRY
    from repro_torch.training import (TrainConfig, init_train_state,
                                      make_train_step)
    from repro_torch.tree import leaves
    state = init_train_state(REGISTRY["olmo-1b"].reduced(), TrainConfig(), 0,
                             device)
    with tempfile.TemporaryDirectory() as d:
        ck = Checkpointer(d, keep=1)
        ck.save(7, state, async_save=True)
        back, manifest = ck.restore(state, device=device)
    same = all(a.dtype == b.dtype and b.device.type == device.type and
               torch.equal(a.detach(), b)
               for a, b in zip(leaves(state), leaves(back)))
    log(f"[train-ckpt] reduced olmo-1b train state ({len(leaves(state))} "
        f"leaves) saved async and restored on the card at step "
        f"{manifest['step']}: bit-equal {same}")
    check(same and manifest["step"] == 7, "the checkpoint round trip on "
          "the card is not bit-equal")
    cfg = REGISTRY["rwkv6-1.6b"].reduced()
    tc = TrainConfig()
    params, opt = init_train_state(cfg, tc, 0, device)
    toks = np.zeros((2, 32), np.int32)
    try:
        make_train_step(cfg, tc, device=device)(
            params, opt, {"tokens": toks, "labels": toks})
        raised = ""
    except RuntimeError as e:
        raised = str(e)
    log(f"[train-rwkv6] reduced rwkv6-1.6b train step on the card raises: "
        f"{raised!r}")
    check("queue 2" in raised, "rwkv6 training on the card did not raise "
          "the documented error")


def phase_training(device, card: str, name: str) -> dict:
    """(a)-(e) of the training slice; returns the backward's record."""
    t0 = time.perf_counter()
    bwd_abs = phase_flash_bwd_vs_plain(device)
    cfg, params, bwd_launches, fwd_launches = phase_train(device, card)
    phase_train_plain_route(cfg, params, device, loss_tol=1e-3,
                            norm_tol=1e-2)
    cfg32 = cfg.replace(dtype=torch.float32)
    params32 = f32_params(params)
    del params
    torch.cuda.empty_cache()
    phase_train_plain_route(cfg32, params32, device, loss_tol=1e-5,
                            leaf_tol=1e-4)
    del params32
    torch.cuda.empty_cache()
    phase_train_small(device)
    record = flash_bwd_record(device, bwd_launches, bwd_abs, name)
    log(f"[train] phase {time.perf_counter() - t0:.1f} s; flash_attention "
        f"launches in the train steps: {fwd_launches} forward, "
        f"{bwd_launches} backward")
    return record


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the "
              "card", file=sys.stderr)
        return 2
    from repro_torch.kernels.maestro_eval import maestro_eval

    device = torch.device("cuda")
    card = card_line()
    log(f"[card] {card}")
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    phase_build()
    tables = vgg_tables()
    max_abs = phase_kernel_vs_plain(tables, device)

    maestro_eval.launches = 0
    phase_main_path(device)
    # run_dse keeps the batched engine, as the reference does: the kernel
    # covers only single-level dataflows and yields no energy or buffers
    log(f"[launches] run_dse_full: maestro_eval {maestro_eval.launches}")
    profile_run_dse(device)
    launches, sweep_abs, sweep_ms = phase_paper_scale(tables, device)
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.linear_scan import linear_scan
    maestro_eval.launches = flash_attention.launches = 0
    linear_scan.launches = 0
    phase_mapsearch(device, card=card)
    log(f"[launches] mapping search: maestro_eval {maestro_eval.launches}, "
        f"flash_attention {flash_attention.launches}, linear_scan "
        f"{linear_scan.launches} (no hand kernel on this path)")
    maestro_eval.launches = flash_attention.launches = 0
    linear_scan.launches = 0
    phase_front_door(device, card=card)
    fd = (maestro_eval.launches, flash_attention.launches,
          linear_scan.launches)
    log(f"[launches] front door: maestro_eval {fd[0]}, flash_attention "
        f"{fd[1]}, linear_scan {fd[2]} (no hand kernel on this path)")
    check(fd == (0, 0, 0), f"the front door launched hand kernels {fd}")
    maestro_eval.launches = flash_attention.launches = 0
    linear_scan.launches = 0
    t_ns = time.perf_counter()
    phase_netsearch(device, card=card)
    log(f"[netsearch] phase {time.perf_counter() - t_ns:.1f} s")
    ns_l = (maestro_eval.launches, flash_attention.launches,
            linear_scan.launches)
    log(f"[launches] network search and run_many: maestro_eval {ns_l[0]}, "
        f"flash_attention {ns_l[1]}, linear_scan {ns_l[2]} (no hand kernel "
        f"on this path)")
    check(ns_l == (0, 0, 0), f"the network search launched hand kernels "
          f"{ns_l}")
    maestro_eval.launches = flash_attention.launches = 0
    linear_scan.launches = 0
    t_sv = time.perf_counter()
    phase_serve(device, card=card)
    log(f"[serve] phase {time.perf_counter() - t_sv:.1f} s")
    sv_l = (maestro_eval.launches, flash_attention.launches,
            linear_scan.launches)
    log(f"[launches] serving tier: maestro_eval {sv_l[0]}, flash_attention "
        f"{sv_l[1]}, linear_scan {sv_l[2]} (no hand kernel on this path)")
    check(sv_l == (0, 0, 0), f"the serving tier launched hand kernels "
          f"{sv_l}")

    name = torch.cuda.get_device_name(0)
    records = [kernel_record(tables, device, launches,
                             max(max_abs, sweep_abs), name, sweep_ms)]
    log(f"[dse] {time.perf_counter() - t0:.1f} s")

    from repro_torch.configs import REGISTRY
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention)
    from repro_torch.kernels.linear_scan import linear_scan, linear_scan_ref
    from repro_torch.kernels.linear_scan import ops as scan_ops
    from repro_torch.models import layers, registry
    from repro_torch.models.param import count_params, init_params
    torch.backends.cuda.matmul.allow_tf32 = False
    log("[flash-vs-plain] torch.backends.cuda.matmul.allow_tf32 = False: "
        "the plain versions' float32 products are full float32")
    flash_abs = phase_flash_vs_plain(device)

    cfg = REGISTRY["llama3-8b"]  # full width and depth
    t1 = time.perf_counter()
    params = init_params(registry.specs(cfg), 0, device)
    sync(device)
    log(f"[llm] {cfg.name} at full width and depth: "
        f"{count_params(registry.specs(cfg))} parameters drawn on the card "
        f"in {time.perf_counter() - t1:.2f} s")
    loss, _, fwd_launches = phase_llm_forward(cfg, params, device,
                                              flash_attention)
    check(np.isfinite(loss) and abs(loss - np.log(cfg.vocab)) < 1.0,
          f"loss {loss} is not near ln(vocab) = {np.log(cfg.vocab):.4f}")
    check(fwd_launches == cfg.n_layers, f"loss_fn launched flash_attention "
          f"{fwd_launches} times, not once per layer ({cfg.n_layers})")
    phase_plain_route(cfg, params, device, layers, "flash_attention",
                      flash_attention, attention_ref, need_argmax=False)
    _, pre_l, dec_l, _ = phase_serving(cfg, params, device, flash_attention)
    check(sum(pre_l) + dec_l == 0, f"serving launched flash_attention "
          f"{sum(pre_l) + dec_l} times; its prefill runs the cache path")
    phase_prefill_vs_decode(cfg, params, device)
    profile_llm(cfg, params, device, "flash_")
    del params
    torch.cuda.empty_cache()
    records.append(flash_record(device, fwd_launches, flash_abs, name))
    log(f"[llama] {time.perf_counter() - t0:.1f} s")

    scan_abs = phase_scan_vs_plain(device)
    cfg = REGISTRY["rwkv6-1.6b"]  # full width and depth
    t1 = time.perf_counter()
    params = init_params(registry.specs(cfg), 0, device)
    sync(device)
    log(f"[llm] {cfg.name} at full width and depth: "
        f"{count_params(registry.specs(cfg))} parameters drawn on the card "
        f"in {time.perf_counter() - t1:.2f} s")
    loss, _, scan_launches = phase_llm_forward(cfg, params, device,
                                               linear_scan)
    check(bool(np.isfinite(loss)), f"rwkv6 loss {loss} is not finite")
    check(scan_launches == cfg.n_layers, f"loss_fn launched linear_scan "
          f"{scan_launches} times, not once per layer ({cfg.n_layers})")
    # bf16: the loss is held to 1e-3, the argmax is not. bf16 rounding
    # flips avalanche through the 24 layers, so any two right scans give
    # last logits ~0.045-0.053 rel L2 apart (float64 vs plain 0.0449 on an
    # H100 80GB HBM3 at 700 W): on seed 0 the top-2 gap is 0.03125, one
    # bf16 step, and the plain route's argmax (40041) is not a float64
    # scan's (59296). The float32 forward below, where no bf16 rounding
    # flips, holds the argmax, and the logits to 1e-3.
    phase_plain_route(cfg, params, device, scan_ops, "scan_op", linear_scan,
                      linear_scan_ref, need_argmax=False)
    cfg32 = cfg.replace(dtype=torch.float32)

    def f32(tree):
        return {k: f32(v) if isinstance(v, dict) else v.float()
                for k, v in tree.items()}
    params32 = f32(params)
    phase_plain_route(cfg32, params32, device, scan_ops, "scan_op",
                      linear_scan, linear_scan_ref, rel_tol=1e-4,
                      l2_tol=1e-3)
    _, pre_l, dec_l, widths = phase_serving(
        cfg, params, device, linear_scan, max_len=128, prompt_lens=(64, 64))
    check(max(widths) <= 96, f"a re-prefill was {max(widths)} wide")
    check(pre_l == [cfg.n_layers] * len(pre_l) and dec_l == 0,
          f"serving launched linear_scan {pre_l} times in its prefills and "
          f"{dec_l} times in decode, not {cfg.n_layers} and 0")
    # bf16 rounding flips avalanche through the 24 layers (a 1e-6 change in
    # the scan moves the last logits by ~2%: phase_plain_route), and at
    # S=128 the chunked form clamps log_w at -60/c = -0.47 where the
    # per-token step does not (the reference's own semantics, ROADMAP queue
    # 3): bf16 at S=128 is held to 0.2, twice its reading of 0.096 on an
    # H100 80GB HBM3 at 700 W; 1e-3 is held in float32 at S=48, where
    # -60/47 lies below every decay -exp(w) ~ -1
    phase_prefill_vs_decode(cfg, params, device, rel_tol=0.2)
    phase_prefill_vs_decode(cfg32, params32, device, S=48, rel_tol=1e-3)
    del params32
    profile_llm(cfg, params, device, "linear_scan")
    del params
    torch.cuda.empty_cache()
    records.append(scan_record(device, scan_launches, scan_abs, name))
    records.append(phase_training(device, card, name))
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    log(json.dumps({"kernels": records}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
