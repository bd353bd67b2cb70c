#!/usr/bin/env python3
"""Ablations of the ``linear_scan`` CUDA kernel at rwkv6-1.6b's scan shape
on one card: each variant is the kernel's source with one part taken out
(or one setting changed) by a textual edit, built with ``nvcc`` into
``build/repro_torch/``, and each of its three passes timed with CUDA events
on the scratch a whole call left.  A variant's numbers say what that part
costs; its outputs are wrong by design and are not checked.

    python3 scripts/ablate_linear_scan.py [--reps 20] [--rounds 2]

Prints one line per variant and round (state, hand-off and output pass and
their sum, in ms) and the card's name and power limit.  Exits non-zero
without a card or when an edit no longer matches the source.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

SHAPE = (2, 2048, 32, 64, 64, False, True, 256)  # chip_smoke.RWKV_SCAN
VARIANTS = {
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


def variant_source(name: str, text: str, out_dir: Path) -> Path:
    for old, new in VARIANTS[name]:
        if text.count(old) != 1:
            raise SystemExit(f"ablate: edit of {name} matches "
                             f"{text.count(old)} places: {old!r}")
        text = text.replace(old, new)
    path = out_dir / f"linear_scan_{name}.cu"
    path.write_text(text)
    return path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=2)
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("ablate_linear_scan: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.kernels.linear_scan.linear_scan import (NVCC_FLAGS, SRC,
                                                             launch_args)
    out_dir = _build.BUILD_DIR / "ablate"
    out_dir.mkdir(parents=True, exist_ok=True)
    text = SRC.read_text()
    srcs = {n: variant_source(n, text, out_dir) for n in VARIANTS}
    with ThreadPoolExecutor(len(srcs)) as ex:
        built = dict(zip(srcs, ex.map(lambda p: _build.build(p, NVCC_FLAGS),
                                      srcs.values())))
    for name, (_, _, report) in built.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[ptxas] {name}: {line.strip()}")
    B, T, H, K, V, post, _, chunk = SHAPE
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def n(*s):
        return torch.randn(s, generator=g, device=dev)
    r, k, v = n(B, T, H, K), n(B, T, H, K), n(B, T, H, V)
    lw = -n(B, T, H, K).abs() * 0.2
    u, s0 = n(H, K), torch.zeros(B, H, K, V, device=dev)
    _, _, args, keep = launch_args(r, k, v, lw, u, s0, chunk, post)
    fns = {}
    for name, (lib, _, _) in built.items():
        fn = ctypes.CDLL(str(lib)).linear_scan_pass
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 9 + [
            ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn

    def time_pass(fn, which):
        for w in range(3):
            if fn(w, *args) != 0:
                raise SystemExit("ablate: launch failed")
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(a.reps):
            fn(which, *args)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / a.reps

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"[card] {card}")
    for rnd in range(a.rounds):
        for name, fn in fns.items():
            ms = [time_pass(fn, w) for w in range(3)]
            print(f"[ablate] {name:24s} r{rnd}: sum {sum(ms):.4f} ms, state "
                  f"{ms[0]:.4f}, hand-off {ms[1]:.4f}, output {ms[2]:.4f}",
                  flush=True)
    del keep
    return 0


if __name__ == "__main__":
    sys.exit(main())
