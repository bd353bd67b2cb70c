#!/usr/bin/env python3
"""Ablations of the ``maestro_eval`` CUDA kernel at the paper-scale sweep's
shape on one card: 2^24 designs (pes 1..16384 x bw 1..1024, as
``chip_smoke.sweep_inputs`` makes them) on the VGG16 table with the most
case rows, as ``chip_smoke.kernel_record`` picks it.  Each variant is the
kernel's source with one part taken out or replaced by a textual edit,
built with ``nvcc`` into the tree's ``build/repro_torch/ablate/`` and timed
with CUDA events.  A variant's time says what that part costs; outputs of
the variants that cut work are wrong by design and are not checked.

    python3 scripts/ablate_maestro_eval.py [--tree DIR] [--reps 20] [--rounds 2]

``--tree`` ablates the kernel of another checkout of the repo (for example
an earlier commit unpacked with ``git archive``); the script knows the
edits of two designs of the kernel, the one-design-per-thread kernel with
20-byte row stores and the kernel whose threads take several designs that
share the terms of a PE count, and takes the set whose every edit
matches that tree's source exactly once.  For each variant it also counts
the SASS instructions of the kernel (``cuobjdump -sass``): in all, and the
calls, backward branches (loops), MUFU, integer-float conversions and
memory instructions among them.  Prints one line per variant and round and
the card's name and power limit.  Exits non-zero without a card or when no
set of edits matches the source.
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import importlib
import os
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
N_PES, N_BW = 16384, 1024  # chip_smoke.sweep_inputs

# stores only, rows made from the loaded inputs
_ROWS = ("const float f = (float)n; row[0] = f; row[1] = b; "
         "row[2] = f + b; row[3] = f * b; row[4] = f - b;")
# the compute kept alive by one store that never happens
_SINK = ("const float sink = runtime + macs + macs / runtime + active_steps "
         "/ fmaxf(total_steps_pe, 1.0f) + (delta + step_eg) / "
         "fmaxf(comp_first, 1.0f);\n  if (sink == -1.25f) out[i] = sink;")
# floordiv_f's remainder without fmodf: the exact fma scheme, fmodf outside
# its domain
_EXACT_MOD = """float mod;
  const float qf = a / b;
  if (fabsf(qf) < 16777216.0f && fabsf(b) <= 3.402823466e38f) {
    mod = fmaf(-truncf(qf), b, a);
    if (a >= 0.0f ? mod < 0.0f : mod > 0.0f) mod += a >= 0.0f ? fabsf(b) : -fabsf(b);
  } else {
    mod = fmodf(a, b);
  }"""

_OLD_STORES = """  float* row = out + i * 5;
  row[0] = runtime;
  row[1] = macs;
  row[2] = macs / runtime;
  row[3] = active_steps / fmaxf(total_steps_pe, 1.0f);
  row[4] = (delta + step_eg) / fmaxf(comp_first, 1.0f);"""
_OLD_HEAD = """  if (i >= n_designs) return;
  const int32_t n = pes[i];
  const float b = bw[i];
"""
_OLD_STAGED = """  __shared__ __align__(16) float stage[256 * 5];
  const bool live = i < n_designs;
  const int32_t n = live ? pes[i] : 1;
  const float b = live ? bw[i] : 1.0f;
  {
    float* row = stage + threadIdx.x * 5;
    """ + _ROWS + """
    __syncthreads();
    const int64_t base = (int64_t)blockIdx.x * 256 * 5;
    if (base + 256 * 5 <= n_designs * 5) {
      for (int k = threadIdx.x; k < 320; k += 256)
        ((float4*)(out + base))[k] = ((const float4*)stage)[k];
    } else {
      for (int k = threadIdx.x; k < 1280; k += 256)
        if (base + k < n_designs * 5) out[base + k] = stage[k];
    }
    return;
  }
"""

EDITS = {
    # one design a thread, each storing its 5 features as a 20-byte row
    "one_per_thread": {
        "kernel": [],
        "stores_rows": [(_OLD_HEAD, _OLD_HEAD + "  {\n    float* row = "
                         "out + i * 5;\n    " + _ROWS + "\n    return;\n"
                         "  }\n")],
        "stores_staged": [(_OLD_HEAD, _OLD_STAGED)],
        "compute_only": [(_OLD_STORES, "  " + _SINK)],
        "exact_mod": [("const float mod = fmodf(a, b);", _EXACT_MOD)],
        "exact_mod_compute_only": [
            ("const float mod = fmodf(a, b);", _EXACT_MOD),
            (_OLD_STORES, "  " + _SINK)],
    },
    # DPT consecutive designs a thread sharing the terms of a PE count,
    # 16-byte loads, rows staged per warp and stored 16 bytes wide
    "shared_pes": {
        "kernel": [],
        "stores_only": [
            ("  PesTerms P = pes_terms(n[0], T, cases);", "  PesTerms P;"),
            ("    if (j > 0 && n[j] != n[j - 1]) P = pes_terms(n[j], T, "
             "cases);", ""),
            ("eval_design(P, b[j], T, cases, f[j]);",
             "{ const float x = (float)n[j]; f[j][0] = x; f[j][1] = b[j]; "
             "f[j][2] = x + b[j]; f[j][3] = x * b[j]; f[j][4] = x - b[j]; }")],
        "compute_only": [("  store_rows(f, stage + threadIdx.x / 32 * 32 * "
                          "DPT * NF, out, w0,\n             n_designs);",
                          "  float sink = 0.0f;\n  for (int j = 0; j < DPT; "
                          "++j)\n    for (int c = 0; c < NF; ++c) sink += "
                          "f[j][c];\n  if (sink == -1.25f) out[i0] = sink;")],
        "no_sharing": [("if (j > 0 && n[j] != n[j - 1]) P =",
                        "if (j > 0) P =")],
        "fmodf": [("  const float mod = exact_fmod(a, b);",
                   "  const float mod = fmodf(a, b);")],
        "hw_intdiv": [("  return floordiv_magic(a, m.magic, m.shift);",
                       "  return floordiv_i(a, m.d);")],
        # both inputs as 16-byte words (the sweep's are 16-byte aligned)
        "loads_16byte": [("#pragma unroll\n  for (int j = 0; j < DPT; ++j) "
                          "{  // past the end: (1, 1.0f), never stored",
                          "  if (i0 + DPT <= n_designs && ((uintptr_t)pes | "
                          "(uintptr_t)bw) % 16 == 0)\n#pragma unroll\n    "
                          "for (int v = 0; "
                          "v < DPT / 4; ++v) {\n      const int4 p4 = "
                          "reinterpret_cast<const int4*>(pes + i0)[v];\n"
                          "      const float4 b4 = reinterpret_cast<const "
                          "float4*>(bw + i0)[v];\n      n[4 * v] = p4.x; "
                          "n[4 * v + 1] = p4.y; n[4 * v + 2] = p4.z; "
                          "n[4 * v + 3] = p4.w;\n      b[4 * v] = b4.x; "
                          "b[4 * v + 1] = b4.y; b[4 * v + 2] = b4.z; "
                          "b[4 * v + 3] = b4.w;\n    }\n  else\n#pragma "
                          "unroll\n  for (int j = 0; j < DPT; ++j) {")],
        # each lane stores its own rows from registers, 16 bytes at a time
        "rows_unstaged": [
            ("  float4* mine = reinterpret_cast<float4*>(wst + lane * DPT * "
             "NF);", "  float4* mine = reinterpret_cast<float4*>(out + (w0 + "
             "lane * DPT) * NF);\n  if (w0 + 32 * DPT <= n_designs) {"),
            ("  __syncwarp();\n  float* dst = out + w0 * NF;\n  if (w0 + 32 "
             "* DPT <= n_designs) {", "  return;\n  }\n  __syncwarp();\n  "
             "float* dst = out + w0 * NF;\n  if (false) {")],
        # what the reference's rule costs beyond the remainder: floor of
        # the quotient from the same division and fma (not its function)
        "no_rule": [("  float div = (a - mod) / b;\n  if (mod != 0.0f && "
                     "((b < 0.0f) != (mod < 0.0f))) div = div - 1.0f;\n  "
                     "return roundf(div);",
                     "  return truncf(a / b) - (mod < 0.0f ? 1.0f : 0.0f);")],
        "dpt8": [("constexpr int DPT = 4;", "constexpr int DPT = 8;")],
    },
}


def variant_sets(text: str) -> tuple[str, dict]:
    for design, variants in EDITS.items():
        if all(text.count(old) == 1 for edits in variants.values()
               for old, _ in edits):
            return design, variants
    raise SystemExit("ablate: no set of edits matches the source exactly "
                     "once")


def variant_source(name: str, edits, text: str, out_dir: Path) -> Path:
    for old, new in edits:
        text = text.replace(old, new)
    path = out_dir / f"maestro_eval_{name}.cu"
    path.write_text(text)
    return path


def sass_counts(lib: Path) -> dict:
    """Instructions of the kernel function in ``cuobjdump -sass`` of
    ``lib`` (its slow-path subroutines included)."""
    tool = shutil.which("cuobjdump") or str(
        Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" /
        "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    body = sass.split("Function : ", 1)[1] if "Function : " in sass else ""
    ops = collections.Counter()
    loops = []
    for m in re.finditer(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?"
                         r"([A-Z][A-Z0-9_.]*)([^;]*);", body):
        addr, op, args = int(m.group(1), 16), m.group(3), m.group(4)
        if op.startswith("NOP"):
            continue
        ops[op.split(".")[0]] += 1
        t = re.search(r"0x([0-9a-f]+)", args)
        if op.startswith("BRA") and t and int(t.group(1), 16) <= addr:
            loops.append((addr - int(t.group(1), 16)) // 16 + 1)
    keep = ("CALL", "MUFU", "I2F", "F2I", "FRND", "LDG", "STG", "LDS",
            "STS", "BAR", "IMAD")
    return {"instructions": sum(ops.values()), "loops": loops,
            **{k: ops.get(k, 0) for k in keep}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", type=Path, default=ROOT)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=2)
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("ablate_maestro_eval: no CUDA device", file=sys.stderr)
        return 2
    tree = a.tree.resolve()
    sys.path.insert(0, str(tree / "src"))
    _build = importlib.import_module("repro_torch.kernels._build")
    mod = importlib.import_module(
        "repro_torch.kernels.maestro_eval.maestro_eval")
    from repro_torch.core import dataflows, dnn_models
    text = mod.SRC.read_text()
    design, variants = variant_sets(text)
    print(f"[ablate] {tree}: the {design} kernel, {len(variants)} variants",
          flush=True)
    out_dir = _build.BUILD_DIR / "ablate"
    out_dir.mkdir(parents=True, exist_ok=True)
    srcs = {n: variant_source(n, e, text, out_dir)
            for n, e in variants.items()}
    with ThreadPoolExecutor(len(srcs)) as ex:
        built = dict(zip(srcs, ex.map(
            lambda p: _build.build(p, mod.NVCC_FLAGS), srcs.values())))
    for name, (lib, _, report) in built.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[ptxas] {name}: {line.strip()}")
        print(f"[sass] {name}: {sass_counts(lib)}", flush=True)

    from repro_torch.kernels.maestro_eval import build_tables
    tables = [build_tables(op, dataflows.table3_for_layer(flow, op))
              for op in dnn_models.vgg16() for flow in ("C-P", "X-P")]
    T = max(tables, key=lambda t: len(t.cases))
    dev = torch.device("cuda")
    pes = torch.arange(1, N_PES + 1, dtype=torch.int32,
                       device=dev).repeat_interleave(N_BW)
    bw = torch.arange(1, N_BW + 1, dtype=torch.float32,
                      device=dev).repeat(N_PES)
    out = torch.empty((pes.numel(), 5), dtype=torch.float32, device=dev)
    cases = mod._device_cases(T, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = (pes.data_ptr(), bw.data_ptr(), out.data_ptr(), pes.numel(),
            mod._c_tables(T), cases.data_ptr(), stream)
    fns = {}
    for name, (lib, _, _) in built.items():
        fn = ctypes.CDLL(str(lib)).maestro_eval_launch
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64, mod._Tables,
                                               ctypes.c_void_p,
                                               ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn

    def time_ms(fn) -> float:
        for _ in range(3):
            if fn(*args) != 0:
                raise SystemExit("ablate: launch failed")
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(a.reps):
            fn(*args)
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
            print(f"[ablate] {design} {name:24s} r{rnd}: "
                  f"{time_ms(fn):.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
