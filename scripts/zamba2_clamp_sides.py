#!/usr/bin/env python3
"""zamba2-7b's float32 gradient check with and without shared clamp sides,
over several train runs on one card.

Each run trains zamba2-7b at full width and ``ZAMBA2_TRAIN_LAYERS`` layers
for ``TRAIN_STEPS`` bf16 steps (``chip_smoke.phase_train``; the flash
backward's float32 atomics make each run's params differ a little), cuts a
float32 copy of the first ``ZAMBA2_F32_LAYERS`` layers and takes one
step's gradients (``registry.loss_fn``, ``torch.autograd.grad``) on four
routes: the kernels, recording each scan call's side of the -60/c clamp
(``chip_smoke.ClampSides``); the plain route (``attention_ref`` and
``linear_scan_ref``) as it is; the plain route on the kernel route's clamp
sides; the float64 scan (``chip_smoke.scan_f64_op``, ``attention_ref``) on
them too.  It then runs ``chip_smoke.phase_train_plain_route`` as the
smoke does.

    python3 scripts/zamba2_clamp_sides.py [--runs 4]

Prints, per run: how many log_w elements sit on the other side of the
clamp on the plain route and how far the farthest lies from it; the
kernel route's largest leaf rel L2 to the plain route as it is (all
leaves, and all but the decay's inputs a_log, w_dt, dt_bias), to the
plain route on shared sides and to the float64 scan on them; whether
each would pass the 1e-4 rule; and the card's name and power limit.
Exits non-zero without a card or when the shared check fails.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

DECAY_INPUTS = ("blocks/a_log", "blocks/w_dt", "blocks/dt_bias")


def grads(cfg, params, batch, scan, attn):
    from repro_torch.kernels.linear_scan import ops as scan_ops
    from repro_torch.models import layers, registry
    kept = scan_ops.scan_op, layers.flash_attention
    scan_ops.scan_op, layers.flash_attention = scan, attn
    try:
        flat = [p for _, p in cs.tree_items(params)]
        loss = registry.loss_fn(params, batch, cfg)
        return list(torch.autograd.grad(loss, flat))
    finally:
        scan_ops.scan_op, layers.flash_attention = kept


def worst(names, got, want, skip=()) -> tuple[str, float]:
    errs = {n: cs.rel_l2(a, b.double()) for n, a, b in zip(names, got, want)
            if n not in skip}
    n = max(errs, key=errs.get)
    return n, errs[n]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("zamba2_clamp_sides: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import REGISTRY
    from repro_torch.kernels.flash_attention import attention_ref
    from repro_torch.kernels.linear_scan import linear_scan, linear_scan_ref
    from repro_torch.models import layers
    device = torch.device("cuda")
    card = cs.card_line()
    flash = layers.flash_attention
    old_fail = new_fail = 0
    for run in range(args.runs):
        t0 = time.perf_counter()
        cfg = REGISTRY["zamba2-7b"].replace(n_layers=cs.ZAMBA2_TRAIN_LAYERS)
        cfg, params, _ = cs.phase_train(device, card, cfg)
        cut = cfg.replace(n_layers=cs.ZAMBA2_F32_LAYERS, dtype=torch.float32)
        p32 = cs.f32_params(cs.cut_layers(params, cs.ZAMBA2_F32_LAYERS))
        del params
        torch.cuda.empty_cache()
        batch = cs.llm_batch(cut, device, *cs.TRAIN_SHAPE, seed=3)
        names = [n for n, _ in cs.tree_items(p32)]
        sides, f64_sides = cs.ClampSides(), cs.ClampSides()
        k = grads(cut, p32, batch, sides.record(linear_scan), flash)
        f64_sides.sides = sides.sides
        p = grads(cut, p32, batch, linear_scan_ref, attention_ref)
        ps = grads(cut, p32, batch, sides.adopt(linear_scan_ref),
                   attention_ref)
        ws = grads(cut, p32, batch, f64_sides.adopt(cs.scan_f64_op),
                   attention_ref)
        kp, kp_held = worst(names, k, p), worst(names, k, p, DECAY_INPUTS)
        kps, kws = worst(names, k, ps), worst(names, k, ws)
        old_fail += kp_held[1] > 1e-4
        new_fail += kps[1] > 1e-4
        print(f"[clamp-sides] run {run}: plain route {sides.line()}; "
              f"float64 scan {f64_sides.adopted} elements, farthest "
              f"{f64_sides.gap:.3g}", flush=True)
        print(f"[clamp-sides] run {run}: kernel route to the plain route as "
              f"it is, largest leaf rel L2 {kp[0]} {kp[1]:.3g}, but the "
              f"decay's inputs {kp_held[0]} {kp_held[1]:.3g} "
              f"({'fails' if kp_held[1] > 1e-4 else 'passes'} 1e-4); on "
              f"shared sides to the plain route {kps[0]} {kps[1]:.3g} "
              f"({'fails' if kps[1] > 1e-4 else 'passes'} 1e-4), to the "
              f"float64 scan {kws[0]} {kws[1]:.3g}", flush=True)
        del k, p, ps, ws, sides, f64_sides
        cs.phase_train_plain_route(cut, p32, device, loss_tol=1e-5,
                                   leaf_tol=1e-4, norm_tol=1e-4)
        del p32
        torch.cuda.empty_cache()
        print(f"[clamp-sides] run {run}: {time.perf_counter() - t0:.1f} s",
              flush=True)
    print(f"[clamp-sides] {args.runs} runs: the 1e-4 rule but the decay's "
          f"inputs, routes as they are, failed {old_fail}; every leaf on "
          f"shared clamp sides failed {new_fail}; {card}", flush=True)
    return 1 if new_fail else 0


if __name__ == "__main__":
    sys.exit(main())
