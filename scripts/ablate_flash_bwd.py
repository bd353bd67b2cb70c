#!/usr/bin/env python3
"""Variants of the flash attention backward's wgmma kernel at head dim 112
(``csrc/flash_attention_bwd.cu``, ``flash_bwd_wgmma_kernel<112>``) at
zamba2-7b's train shape on one card.  Each variant is the source with one
choice changed by a textual edit, built with ``nvcc`` into
``build/repro_torch/ablate/``; every variant computes the same gradients,
so each is held against ``attention_bwd_ref`` (rel L2 of dq, dk, dv within
2e-2, both masks) before it is timed with CUDA events, in turns.

    python3 scripts/ablate_flash_bwd.py [--reps 20] [--rounds 2]
        [--other DIR]

Variants: ``kernel`` (the source as it is: dQ's second warpgroup runs
m64n64k16 over the whole second box, zero-filled columns 112-127
included, and adds only columns 64-111; the warpgroup index is made
warp-uniform by a shuffle); ``n48`` (that warpgroup runs m64n48k16 on its
48 real columns, behind a branch on the warpgroup index);
``n48DivergentWg`` (the same, the index taken as ``threadIdx.x / 128``,
which ptxas reads as divergent); ``divergentWg`` (the kernel with that
index).  With ``--other DIR`` the backward source of another checkout
(e.g. a ``git archive`` of the parent under ``build/``) is built and timed
in the same rounds, unedited.

Prints each variant's ptxas registers, spills and any serialization
notice for the D = 112 instance, one line per variant and round, and the
card's name and power limit.  Exits non-zero without a card, when an edit
no longer matches the source or when a variant disagrees.
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

SHAPE = (2, 2048, 32, 32, 112, True)  # chip_smoke.ZAMBA2_BWD
CHECKS = [SHAPE, (1, 384, 6, 2, 112, True), (1, 384, 6, 2, 112, False)]
TOL = 2e-2
N48_ASM = r"""// m64n48k16, as wgmma_ss_n64, into the first 24 floats of d
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n48(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23}, "
      "%24, %25, p, 1, 1, %27, %28;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

"""
DQ_LOOP = """#pragma unroll
    for (int kk = 0; kk < C::DQ_KEYS / 16; ++kk)
      wgmma_ss_n64<1, 1>(dqa, sw128_desc(ds_addr + kk * ROWS8, W_BK * BOX_ROW),
                         sw128_desc(kb_addr + kk * ROWS8, W_BK * BOX_ROW),
                         kk > 0);
"""
N48_LOOP = """    if (C::DQ_N1 == 64 || wg == 0) {
""" + DQ_LOOP + """    } else {
#pragma unroll
      for (int kk = 0; kk < C::DQ_KEYS / 16; ++kk)
        wgmma_ss_n48<1, 1>(dqa, sw128_desc(ds_addr + kk * ROWS8,
                                           W_BK * BOX_ROW),
                           sw128_desc(kb_addr + kk * ROWS8, W_BK * BOX_ROW),
                           kk > 0);
    }
"""
WG = ("  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);",
      "  const int wg = tid / 128;")
RS_ANCHOR = "// wgmma.mma_async m64nNk16, float32 += bf16 x bf16: A from registers"
N48 = [(RS_ANCHOR, N48_ASM + RS_ANCHOR), (DQ_LOOP, N48_LOOP)]
VARIANTS = {
    "kernel": [],
    # dQ's second warpgroup on m64n48k16 (its 48 real columns) behind a
    # branch on the warp-uniform warpgroup index
    "n48": N48,
    # the same branch on tid / 128, which ptxas takes as divergent
    "n48DivergentWg": N48 + [WG],
    # the kernel with the warpgroup index from tid / 128
    "divergentWg": [WG],
}


def build_variant(name: str, src: Path, edits, flags):
    from repro_torch.kernels import _build
    text = src.read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"{name}: the edit {old!r} matches "
                             f"{text.count(old)} times, not once")
        text = text.replace(old, new)
    path = ROOT / "build" / "repro_torch" / "ablate" / name / src.name
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text)
    return _build.build(path, flags)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--other", type=Path, default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("ablate_flash_bwd: no CUDA device", file=sys.stderr)
        return 2
    from importlib import import_module
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import (
        attention_bwd_ref, flash_attention_bwd, flash_attention_with_lse)
    fa = import_module("repro_torch.kernels.flash_attention.flash_attention")
    src = fa.BWD_SRC
    jobs = {n: (src, e) for n, e in VARIANTS.items()}
    if args.other is not None:
        jobs["other"] = (args.other / src.relative_to(ROOT), [])
    with ThreadPoolExecutor(len(jobs)) as ex:
        futs = {n: ex.submit(build_variant, n, s, e, fa.NVCC_FLAGS)
                for n, (s, e) in jobs.items()}
        built = {n: f.result() for n, f in futs.items()}
    libs = {}
    for n, (path, seconds, report) in built.items():
        for fn, regs, st, ld in _build.ptxas_table(report):
            if "wgmma_kernelILi112E" in fn or \
                    ("9flash_bwdI13__nv_bfloat16Li112E" in fn):
                print(f"[ablate] {n}: {fn[-60:]} {regs} registers, spill "
                      f"stores {st}, loads {ld} bytes; built in "
                      f"{seconds:.1f} s")
        for line in report.splitlines():
            if "Performance Loss" in line and "Li112E" in line:
                why = line.split("serialized")[1].split(" in the")[0]
                print(f"[ablate] {n}: ptxas: wgmma serialized "
                      f"({why.strip()})")
        lib = ctypes.CDLL(str(path))
        fn = lib.flash_attention_bwd_launch
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        libs[n] = lib

    dev = torch.device("cuda")

    def inputs(shape, seed):
        B, S, Hq, Hkv, D, causal = shape
        g = torch.Generator(device=dev).manual_seed(seed)
        q = torch.randn((B, S, Hq, D), generator=g, device=dev)
        k, v = (torch.randn((B, S, Hkv, D), generator=g, device=dev)
                for _ in range(2))
        do = torch.randn((B, S, Hq, D), generator=g, device=dev)
        q, k, v, do = (t.to(torch.bfloat16) for t in (q, k, v, do))
        o, lse = flash_attention_with_lse(q, k, v, causal=causal)
        return q, k, v, o, do, lse, causal

    def use(n):
        fa._bwd_library = lambda: libs[n]

    bad = []
    for shape in CHECKS:
        q, k, v, o, do, lse, causal = inputs(shape, 5)
        want = attention_bwd_ref(q, k, v, o, do, causal=causal)
        for n in libs:
            use(n)
            got = flash_attention_bwd(q, k, v, o, do, lse=lse, causal=causal)
            torch.cuda.synchronize()
            errs = [float((g.float() - w.float()).norm() / w.float().norm())
                    for g, w in zip(got, want)]
            print(f"[ablate] {n} {shape}: rel L2 dq {errs[0]:.3g}, dk "
                  f"{errs[1]:.3g}, dv {errs[2]:.3g} (limit {TOL})")
            if not max(errs) <= TOL:
                bad.append((n, shape))
    q, k, v, o, do, lse, causal = inputs(SHAPE, 5)
    order = list(libs)
    for r in range(args.rounds):
        times = {}
        for n in (order if r % 2 == 0 else order[::-1]):
            use(n)

            def call():
                flash_attention_bwd(q, k, v, o, do, lse=lse, causal=causal)
            call()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(args.reps):
                call()
            end.record()
            torch.cuda.synchronize()
            times[n] = start.elapsed_time(end) / args.reps
        print(f"[ablate] round {r} at {SHAPE} bf16, ms a call: " + ", ".join(
            f"{n} {times[n]:.4f}" for n in order))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"[ablate] card: {card.strip()}")
    if bad:
        print(f"[ablate] disagree: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
