"""LLM-inference serving launcher: prefill a batch of requests, then
batched decode.

    PYTHONPATH=src python -m repro_torch.launch.llmserve --arch olmo-1b \
        --requests 4 --prompt-len 64 --gen 32 --reduced

The flags are the JAX package's.  As there, ``--reduced`` is on by default
and no flag turns it off.  ``--device`` names where to run (``cuda``
unless given); weights are random, drawn from seed 0.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import REGISTRY, get_config
from ..devices import resolve_device
from ..models import registry
from ..models.param import init_params


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(REGISTRY), default="olmo-1b")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    params = init_params(registry.specs(cfg), 0, device)
    B, P = args.requests, args.prompt_len
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab, (B, P)), dtype=torch.int32,
        device=device)}
    if cfg.frontend == "vision":
        batch["frontend"] = torch.zeros(
            (B, cfg.frontend_len, cfg.frontend_dim), device=device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    max_len = P + args.gen
    with torch.no_grad():
        t0 = time.perf_counter()
        logits, cache = registry.prefill(params, batch, cfg, max_len)
        tok = torch.argmax(logits[:, -1], -1)[:, None]
        sync()
        t_prefill = time.perf_counter() - t0

        out = [tok]
        t0 = time.perf_counter()
        for _ in range(args.gen - 1):
            logits, cache = registry.decode_step(params, {"tokens": tok},
                                                 cache, cfg)
            tok = torch.argmax(logits[:, -1], -1)[:, None]
            out.append(tok)
        sync()
        t_dec = time.perf_counter() - t0
    toks = torch.cat(out, dim=1)
    print(f"prefill {B}x{P} in {t_prefill:.2f}s; "
          f"decoded {args.gen - 1} steps in {t_dec:.2f}s "
          f"({B * (args.gen - 1) / max(t_dec, 1e-9):.1f} tok/s)")
    print("sample:", toks[0, :16].cpu().numpy())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
