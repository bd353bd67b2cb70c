#!/usr/bin/env python3
"""Ablations of the ``linear_scan`` CUDA kernels at rwkv6-1.6b's scan shape
on one card: the forward (``csrc/linear_scan.cu``) or, with ``--bwd``, the
backward (``csrc/linear_scan_bwd.cu``).  Each variant is the source with
one part taken out (or one setting changed) by a textual edit, built with
``nvcc`` into ``build/repro_torch/ablate/``; the whole call (its three
passes back to back) and each pass alone are timed with CUDA events on
the scratch a whole call left.  A variant's numbers say what that part
costs; its outputs are wrong by design and are not checked.  With
``--other DIR`` the same source of another checkout (e.g. a ``git
archive`` of the parent under ``build/``) is built and timed in the same
rounds, as "other", unedited.

    python3 scripts/ablate_linear_scan.py [--bwd] [--reps 20] [--rounds 2]
        [--other DIR]

Prints each variant's ptxas registers and spills, one line per variant and
round (the whole call and each pass, in ms), and the card's name and power
limit.  Exits non-zero without a card or when an edit no longer matches
the source.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

SHAPE = (2, 2048, 32, 64, 64, False, True, 256)  # chip_smoke.RWKV_SCAN
FWD_VARIANTS = {
    "kernel": [],
    "st_noScan": [("  scan_tile(Pt, n, K, part);\n  // k exp(-P)",
                   "  // k exp(-P)")],
    "st_noMma": [("  mma_cols(Kn, Vn, TILE, ty, tx, acc);", "")],
    "out_noScan": [("  scan_tile(Pt, n, K, part);\n  // q_eff",
                    "  // q_eff")],
    "out_noBonus": [("    if (u != nullptr) {  // r . (u * k), row by row",
                     "    if (false) {")],
    "out_noInter": [("  mma_cols(AT, Pt, KP, ty, tx, acc);", "")],
    "out_noA": [("  mma_rows(Qe, Kn, KP, ty, tx, a);", "")],
    "out_noAV": [("  mma_cols(AT, Vn, 8 * (tid / 32) + 8, ty, tx, acc);",
                  "")],
    "out_wholeAV": [("mma_cols(AT, Vn, 8 * (tid / 32) + 8, ty, tx, acc)",
                     "mma_cols(AT, Vn, TILE, ty, tx, acc)")],
}
MMA_ASM = ('  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "\n'
           '      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, '
           '{%0, %1, %2, %3};\\n"\n'
           '      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])\n'
           '      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), '
           '"r"(b1));\n')
BWD_VARIANTS = {  # all in the gradient pass, lsb_grad
    "kernel": [],
    # every product gone: the fragment loads and splits die with it
    "noProducts": [(MMA_ASM, "")],
    # TF32 alone: hi*hi, the two remainder products gone
    "tf32Only": [(
        "      for (int mt = 0; mt < MT; ++mt) mma8(acc[mt][nt], al[mt], bh0, "
        "bh1);\n#pragma unroll\n      for (int mt = 0; mt < MT; ++mt) "
        "mma8(acc[mt][nt], ah[mt], bl0, bl1);\n#pragma unroll\n", "")],
    # dO and v element by element in float32 too (S and G by cp.async)
    "mixLoads": [("        if constexpr (f32) {\n          const bool okv",
                  "        if constexpr (false) {\n          const bool okv"),
                 ("    if constexpr (!VEC || !f32) {",
                  "    if constexpr (true) {")],
    # the element-by-element phase without its exps and divisions
    "noExpDiv": [("        const float ePq = expf(post ? P : P - Lw[o]), "
                  "emP = expf(-P);",
                  "        const float ePq = P, emP = P;"),
                 ("          const float rr = q / ePq, kr = kap / emP;",
                  "          const float rr = q, kr = kap;")],
    # neither scan of P (the dlog_w column scan stays: it stores dlog_w)
    "noScans": [("    Am[o] = Lw[o];\n  }\n  scan_tile<true>(Am, n, K, part);",
                 "    Am[o] = Lw[o];\n  }\n"),
                ("  scan_tile<true>(Am, n, K, part);  // P, the forward's "
                 "bits", "")],
    # no stores of dr, dk and dv (dlog_w and du stay)
    "noStores": [("          store2(dr + at, gr[0], gr[1], k0 + 1 < K, K % 2 "
                  "== 0);\n          store2(dk + at, gk[0], gk[1], k0 + 1 < "
                  "K, K % 2 == 0);\n", ""),
                 ("          store2(dv + baseV + j * rowV + v0 + col, "
                  "acc[0][nt][e],\n                 acc[0][nt][e + 1], col "
                  "+ 1 < nv, V % 2 == 0);", "          ;")],
}
PASSES = {False: ("state", "hand-off", "output"),
          True: ("reverse state", "reverse hand-off", "gradient")}


def variant_source(name: str, edits, text: str, stem: str,
                   out_dir: Path) -> Path:
    """The source with ``edits`` (old, new) applied, each matching once,
    written to ``out_dir``."""
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"ablate: edit of {name} matches "
                             f"{text.count(old)} places: {old!r}")
        text = text.replace(old, new)
    path = out_dir / f"{stem}_{name}.cu"
    path.write_text(text)
    return path


def pass_args(torch, ls, bwd: bool, dev):
    """(the C arguments after ``which`` of the mode's ``*_pass`` function,
    the tensors they point at) at ``SHAPE`` from seed 0; the backward's
    saved states come from the forward kernel."""
    B, T, H, K, V, post, _, chunk = SHAPE
    g = torch.Generator(device=dev).manual_seed(0)

    def n(*s):
        return torch.randn(s, generator=g, device=dev)
    r, k, v = n(B, T, H, K), n(B, T, H, K), n(B, T, H, V)
    lw = -n(B, T, H, K).abs() * 0.2
    u = n(H, K)
    if not bwd:
        s0 = torch.zeros(B, H, K, V, device=dev)
        _, _, args, keep = ls.launch_args(r, k, v, lw, u, s0, chunk, post)
        return args, keep
    do = n(B, T, H, V)
    _, _, states = ls.linear_scan_with_states(r, k, v, lw, u, None,
                                              chunk=chunk, post_update=post)
    nt = T // chunk * -(-chunk // 64)
    outs = [torch.empty_like(t) for t in (r, k, v, lw)] + [
        torch.zeros((B, H, nt, K), device=dev),
        torch.zeros((B, H, K, V), device=dev)]
    scratch = torch.empty(B * H * nt * K * V, device=dev)
    args = ls.bwd_args(r, k, v, lw, u, do, None, states, scratch, *outs,
                       chunk, post, torch.cuda.current_stream(dev).cuda_stream)
    return args, (r, k, v, lw, u, do, states, outs, scratch)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bwd", action="store_true",
                    help="the backward (variants of its gradient pass)")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--other", type=Path, default=None,
                    help="another checkout whose source is timed as well")
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("ablate_linear_scan: no CUDA device", file=sys.stderr)
        return 2
    from importlib import import_module
    from repro_torch.kernels import _build
    ls = import_module("repro_torch.kernels.linear_scan.linear_scan")
    src = ls.BWD_SRC if a.bwd else ls.SRC
    variants = BWD_VARIANTS if a.bwd else FWD_VARIANTS
    out_dir = _build.BUILD_DIR / "ablate"
    out_dir.mkdir(parents=True, exist_ok=True)
    text = src.read_text()
    srcs = {n: variant_source(n, e, text, src.stem, out_dir)
            for n, e in variants.items()}
    if a.other is not None:
        srcs["other"] = variant_source(
            "other", [], (a.other / src.relative_to(ROOT)).read_text(),
            src.stem, out_dir)
    with ThreadPoolExecutor(len(srcs)) as ex:
        reports = dict(zip(srcs, ex.map(
            lambda p: _build.build(p, ls.NVCC_FLAGS)[2], srcs.values())))
    for name, report in reports.items():
        for fn, regs, st, ld in _build.ptxas_table(report):
            print(f"[ptxas] {name}: {fn[-60:]}: {regs} registers, spill "
                  f"stores {st} bytes, spill loads {ld} bytes")
    fns = {n: (ls._bwd_library(p).linear_scan_bwd_pass if a.bwd
               else ls._library(p).linear_scan_pass)
           for n, p in srcs.items()}
    args, keep = pass_args(torch, ls, a.bwd, torch.device("cuda"))

    def time_passes(fn, passes):
        for w in range(3):
            if fn(w, *args) != 0:
                raise SystemExit("ablate: launch failed")
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(a.reps):
            for w in passes:
                fn(w, *args)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / a.reps

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"[card] {card}")
    for rnd in range(a.rounds):
        order = list(fns) if rnd % 2 == 0 else list(fns)[::-1]
        for name in order:
            fn = fns[name]
            each = ", ".join(f"{p} {time_passes(fn, (w,)):.4f}"
                             for w, p in enumerate(PASSES[a.bwd]))
            print(f"[ablate] {name:12s} r{rnd}: whole call "
                  f"{time_passes(fn, (0, 1, 2)):.4f} ms; {each}", flush=True)
    del keep
    return 0


if __name__ == "__main__":
    sys.exit(main())
