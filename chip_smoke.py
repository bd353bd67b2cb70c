#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit code and no result):

1. require CUDA; print the card's name and power limit; build the
   ``maestro_eval`` kernel from ``src/repro_torch/kernels/maestro_eval/csrc``
   and print the build seconds and ptxas report;
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
   chunk, rtol 1e-6.

Kernel launch counts are set to 0 just before each path (``run_dse_full``;
one timed pass of the paper-scale sweep) and read just after it.
The last two lines are the card's ``nvidia-smi`` name and power limit and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
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
BW_SXM, BW_PCIE = 3.35e12, 2.0e12   # H100 SXM / PCIe device memory, B/s
BYTES_PER_DESIGN = 8 + 20    # pes + bw in, 5 float32 features out
RTOL = 1e-6


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
    from repro_torch.kernels.maestro_eval.maestro_eval import build
    lib, seconds, report = build()
    log(f"[build] {lib.name}: {seconds:.2f} s")
    for line in report.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] ptxas: {line.strip()}")


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
    # the kernel's integer ceil(log2 n) against the plain float formula
    n = torch.arange(1, 16385, dtype=torch.int32, device=device)
    flt = torch.ceil(torch.log2(n.to(torch.float32))).cpu().numpy()
    check(all(int(f) == (k - 1).bit_length()
              for k, f in zip(range(1, 16385), flt)),
          "float ceil(log2 n) disagrees with the integer bit length")
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
        f"{worst_rel:.3g} (rtol {RTOL})")
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


def profile_run_dse(device, cfg=None) -> None:
    """Where one ``run_dse`` call at the default grid spends its time: the
    card's busy time (kernels and copies, by ``torch.profiler``) against
    the call's wall time, and the host-side operators that dominate."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import dnn_models
    from repro_torch.core.dataflows import table3_for_layer
    from repro_torch.core.dse import DSEConfig, run_dse
    cfg = cfg or DSEConfig()
    op = next(o for o in dnn_models.vgg16() if o.name == "vgg16-conv11")
    df = table3_for_layer("KC-P", op)
    run_dse(op, df, cfg, device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = run_dse(op, df, cfg, device=device)
    plain_wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_dse(op, df, cfg, device=device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_s = sum(e.time_range.elapsed_us() for e in dev) / 1e6
    by_name: dict[str, list] = {}
    for e in dev:
        s = by_name.setdefault(e.name, [0, 0.0])
        s[0] += 1
        s[1] += e.time_range.elapsed_us()
    log(f"[profile] run_dse vgg16-conv11 KC-P base, {r.n_evaluated} "
        f"designs: wall {plain_wall:.4f} s unprofiled, {wall:.4f} s "
        f"profiled; device busy {busy_s:.6f} s in {len(dev)} kernels and "
        f"copies: idle share {1 - busy_s / wall:.4f}")
    for name, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1]
                                )[:5]:
        log(f"[profile]   device {us / 1e3:.3f} ms in {n} x {name[:70]}")
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    for e in host[:6]:
        log(f"[profile]   host self {e.self_cpu_time_total / 1e3:.3f} ms in "
            f"{e.count} x {e.key[:70]}")


def sweep_inputs(device, n_pes: int = 16384, n_bw: int = 1024):
    pes = torch.arange(1, n_pes + 1, dtype=torch.int32,
                       device=device).repeat_interleave(n_bw)
    bw = torch.arange(1, n_bw + 1, dtype=torch.float32,
                      device=device).repeat(n_pes)
    return pes, bw


def phase_paper_scale(tables, device, n_pes: int = 16384,
                      n_bw: int = 1024) -> tuple[int, float]:
    """The sweep, timed over one pass after a warm-up pass; the launch count
    is set to 0 just before the timed pass and read just after it.  Then the
    kernel against its plain version on every table's chunk, the shape the
    sweep launches it at.  Returns (launches, max abs error)."""
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
    for op, df, T in tables:
        got = maestro_eval(pes, bw, tables=T)
        want = closed_form_features(pes, bw, T)
        check(bool(torch.isfinite(got).all()), f"{op.name} {df.name}: "
              f"non-finite kernel output on the {n}-design chunk")
        a, r = rel_err(got, want)
        worst_abs, worst_rel = max(worst_abs, a), max(worst_rel, r)
        check(r <= RTOL, f"{op.name} {df.name}: kernel vs plain rel err "
              f"{r:.3g} > {RTOL} on the {n}-design chunk")
        del got, want
    log(f"[paper-scale] kernel vs plain on {len(tables)} tables x {n} "
        f"designs: max abs err {worst_abs:.6g}, max rel err "
        f"{worst_rel:.3g} (rtol {RTOL})")
    return launches, worst_abs


def fp32_ops_per_design(T) -> int:
    """float32 operations of one design in ``csrc/maestro_eval.cu``,
    counted from the source: each add, sub, mul, div, max, fmod and round is
    one; 50 outside the case loop, one more for an o-coupled egress, 21 per
    case row.  ``floordiv_f``'s sign correction never fires on this sweep's
    positive operands.  Integer operations are left out: the card's
    published rates give none for int32 outside the tensor cores."""
    return 50 + int(T.o_coupled_spatial) + 21 * len(T.cases)


def kernel_record(tables, device, launches: int, max_abs_err: float,
                  name: str) -> dict:
    """Timing of one 2^24-design chunk: the kernel, its plain version and
    the bound, on the table with the most case rows."""
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
    log(f"[kernel] maestro_eval on {op.name} {df.name} ({len(T.cases)} "
        f"case rows), {n} designs: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {max(bytes_ms, ops_ms):.4f} ms")
    return {
        "name": "maestro_eval", "route": "cuda",
        "source": "src/repro_torch/kernels/maestro_eval/csrc/maestro_eval.cu",
        "replaces": "src/repro/kernels/maestro_eval/maestro_eval.py:115",
        "launches": launches, "max_abs_err": max_abs_err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
    }


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
    launches, sweep_abs = phase_paper_scale(tables, device)

    record = kernel_record(tables, device, launches,
                           max(max_abs, sweep_abs),
                           torch.cuda.get_device_name(0))
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    log(json.dumps({"kernels": [record]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
