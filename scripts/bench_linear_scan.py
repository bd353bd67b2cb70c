#!/usr/bin/env python3
"""Time the port's ``linear_scan`` kernel at rwkv6-1.6b's scan shape on one
CUDA card, in this checkout and, with ``--other``, in another checkout of
the repo (for example an earlier commit unpacked with ``git archive``), in
turns: this, other, other, this.

    python3 scripts/bench_linear_scan.py [--other DIR] [--reps 50]

Each turn runs in its own process (both trees name their package
``repro_torch``), builds the tree's kernel from its own sources into that
tree's ``build/``, and prints one JSON line: the tree, the mean
milliseconds over ``--reps`` launches timed with CUDA events after a
warm-up, and the card's name and power limit.  Inputs as ``chip_smoke.py``
draws them (float32, seed 0, log_w = -|N(0, 1)| * 0.2).  Exits non-zero
without a card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPE = (2, 2048, 32, 64, 64, False, True, 256)  # chip_smoke.RWKV_SCAN


def child(tree: Path, reps: int) -> None:
    import torch
    sys.path.insert(0, str(tree / "src"))
    from repro_torch.kernels.linear_scan import linear_scan
    B, T, H, K, V, post, _, chunk = SHAPE
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def n(*s):
        return torch.randn(s, generator=g, device=dev)
    r, k, v = n(B, T, H, K), n(B, T, H, K), n(B, T, H, V)
    lw = -n(B, T, H, K).abs() * 0.2
    u, s0 = n(H, K), torch.zeros(B, H, K, V, device=dev)

    def run():
        return linear_scan(r, k, v, lw, u, s0, chunk=chunk, post_update=post)
    run()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        run()
    end.record()
    torch.cuda.synchronize()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"tree": str(tree), "shape": SHAPE,
                      "ms": start.elapsed_time(end) / reps, "card": card}),
          flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, default=None)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--child", type=Path, default=None, help=argparse.SUPPRESS)
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("bench_linear_scan: no CUDA device", file=sys.stderr)
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
