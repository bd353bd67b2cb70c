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


def draw_batch(cfg, B: int, P: int, device) -> dict:
    """The CLI's batch, drawn from seed 0 as the JAX package's: B prompts
    of P tokens; the vision frontend's zeros, or the encoder-decoder's P
    float32 frames ~ N(0, 1)."""
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab, (B, P)), dtype=torch.int32,
        device=device)}
    if cfg.frontend == "vision":
        batch["frontend"] = torch.zeros(
            (B, cfg.frontend_len, cfg.frontend_dim), device=device)
    if cfg.is_encdec:
        batch["frontend"] = torch.as_tensor(
            rng.normal(size=(B, P, cfg.frontend_dim)), dtype=torch.float32,
            device=device)
    return batch


def serve(params, cfg, batch: dict, gen: int, device, probe=None):
    """Prefill ``batch`` into a cache of its prompt + ``gen`` positions,
    then ``gen - 1`` greedy decode steps.  Returns (prefill seconds, decode
    seconds, the tokens (B, gen), what ``probe()`` reads just after the
    prefill and just after the decode steps, [] without ``probe``)."""
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    reads = []
    max_len = batch["tokens"].shape[1] + gen
    with torch.no_grad():
        t0 = time.perf_counter()
        logits, cache = registry.prefill(params, batch, cfg, max_len)
        tok = torch.argmax(logits[:, -1], -1)[:, None]
        sync()
        t_prefill = time.perf_counter() - t0
        reads += [probe()] if probe else []

        out = [tok]
        t0 = time.perf_counter()
        for _ in range(gen - 1):
            logits, cache = registry.decode_step(params, {"tokens": tok},
                                                 cache, cfg)
            tok = torch.argmax(logits[:, -1], -1)[:, None]
            out.append(tok)
        sync()
        t_dec = time.perf_counter() - t0
        reads += [probe()] if probe else []
    return t_prefill, t_dec, torch.cat(out, dim=1), reads


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
    batch = draw_batch(cfg, B, P, device)
    t_prefill, t_dec, toks, _ = serve(params, cfg, batch, args.gen, device)
    print(f"prefill {B}x{P} in {t_prefill:.2f}s; "
          f"decoded {args.gen - 1} steps in {t_dec:.2f}s "
          f"({B * (args.gen - 1) / max(t_dec, 1e-9):.1f} tok/s)")
    print("sample:", toks[0, :16].cpu().numpy())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
