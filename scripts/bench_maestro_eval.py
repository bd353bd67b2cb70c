#!/usr/bin/env python3
"""Time the port's ``maestro_eval`` kernel at the paper-scale sweep's shape
on one CUDA card, in this checkout and, with ``--other``, in another
checkout of the repo (for example an earlier commit unpacked with ``git
archive``), in turns: this, other, other, this.

    python3 scripts/bench_maestro_eval.py [--other DIR] [--reps 50]

Each turn runs in its own process (both trees name their package
``repro_torch``), builds the tree's kernel from its own sources into that
tree's ``build/``, and prints one JSON line: the tree; the mean
milliseconds of one launch on 2^24 designs (pes 1..16384 x bw 1..1024, as
``chip_smoke.sweep_inputs`` makes them) over ``--reps`` launches timed with
CUDA events after a warm-up, on the VGG16 table with the most case rows
(``ms``, as ``chip_smoke.kernel_record`` picks it) and averaged over all 32
VGG16 x {C-P, X-P} tables (``ms_all_tables``); the sweep as
``chip_smoke.phase_paper_scale`` runs it, 32 launches each followed by the
argmax of the throughput column, timed over one pass (``sweep_ms``) and the
32 launches alone (``sweep_kernels_ms``); the launches counted; whether the
kernel's output is bit-equal to the plain version on each table
(``bit_equal_tables``); and the card's name and power limit.  Exits
non-zero without a card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
N_PES, N_BW = 16384, 1024  # chip_smoke.sweep_inputs


def child(tree: Path, reps: int) -> None:
    import torch
    sys.path.insert(0, str(tree / "src"))
    from repro_torch.core import dataflows, dnn_models
    from repro_torch.kernels.maestro_eval import (build_tables,
                                                  closed_form_features,
                                                  maestro_eval)
    tables = [build_tables(op, dataflows.table3_for_layer(flow, op))
              for op in dnn_models.vgg16() for flow in ("C-P", "X-P")]
    dev = torch.device("cuda")
    pes = torch.arange(1, N_PES + 1, dtype=torch.int32,
                       device=dev).repeat_interleave(N_BW)
    bw = torch.arange(1, N_BW + 1, dtype=torch.float32,
                      device=dev).repeat(N_PES)

    def time_ms(fn, n: int) -> float:
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / n

    T = max(tables, key=lambda t: len(t.cases))
    ms = time_ms(lambda: maestro_eval(pes, bw, tables=T), reps)
    per_table = [time_ms(lambda: maestro_eval(pes, bw, tables=t),
                         max(reps // 10, 2)) for t in tables]

    def sweep(argmax: bool):
        def run():
            for t in tables:
                out = maestro_eval(pes, bw, tables=t)
                if argmax:
                    torch.argmax(out[:, 2])
        return run
    sweep_ms = time_ms(sweep(True), 1)
    maestro_eval.launches = 0
    kernels_ms = time_ms(sweep(False), 1)
    launches = maestro_eval.launches // 2  # the warm-up pass and the timed
    equal = 0
    for t in tables:
        equal += bool(torch.equal(maestro_eval(pes, bw, tables=t),
                                  closed_form_features(pes, bw, t)))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"tree": str(tree), "designs": pes.numel(), "ms": ms,
                      "ms_all_tables": sum(per_table) / len(per_table),
                      "sweep_ms": sweep_ms, "sweep_kernels_ms": kernels_ms,
                      "launches_per_sweep": launches,
                      "bit_equal_tables": f"{equal}/{len(tables)}",
                      "card": card}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, default=None)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--child", type=Path, default=None, help=argparse.SUPPRESS)
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("bench_maestro_eval: no CUDA device", file=sys.stderr)
        return 2
    if a.child is not None:
        child(a.child.resolve(), a.reps)
        return 0
    trees = [ROOT] if a.other is None else [ROOT, a.other, a.other, ROOT]
    for tree in trees:
        rc = subprocess.run([sys.executable, __file__, "--child", str(tree),
                             "--reps", str(a.reps)]).returncode
        if rc != 0:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
