"""Training launcher: real steps on one device (the CPU for smoke runs, the
card by default).

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \
        --steps 20 --batch 8 --seq 128 --reduced

The flags are the JAX package's, plus ``--device`` (``cuda`` unless
given).  As there, ``--reduced`` is on by default and no flag turns it
off; a full-width run goes through the library (``training``, ``ft``).
Weights are random, drawn from seed 0.  Checkpoints go to ``--ckpt-dir``
(by default a directory under the system's temporary directory).
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from ..checkpoint import Checkpointer
from ..configs import REGISTRY, get_config
from ..data import batch_for_step
from ..devices import resolve_device
from ..ft import FaultTolerantLoop, FTConfig
from ..models import registry
from ..models.param import init_params
from ..optim import adamw
from ..training import TrainConfig, make_train_step
from ..tree import leaves


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(REGISTRY), default="olmo-1b")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    tc = TrainConfig(
        microbatches=args.microbatches,
        compress_grads=args.compress_grads,
        opt=adamw.AdamWConfig(lr=args.lr, warmup_steps=10,
                              total_steps=args.steps))
    # the state as the reference's CLI builds it: no error feedback, which
    # compress_decompress starts at zero on the first compressed step, so a
    # resume restores only params and the moments (a saved feedback is
    # dropped, as there)
    params = init_params(registry.specs(cfg), 0, device)
    for p in leaves(params):
        p.requires_grad_(True)
    opt_state = adamw.init_state(params)
    step_fn = make_train_step(cfg, tc, device=device)

    ckpt = Checkpointer(args.ckpt_dir, keep=2)
    start = 0
    if args.resume and ckpt.latest_step() is not None:
        (params, opt_state), manifest = ckpt.restore((params, opt_state),
                                                     device=device)
        start = manifest["step"]
        print(f"resumed from step {start}")

    def batch_fn(step):
        b = batch_for_step(step, global_batch=args.batch, seq=args.seq,
                           vocab=cfg.vocab)
        if cfg.frontend == "vision":
            b["frontend"] = np.zeros(
                (args.batch, cfg.frontend_len, cfg.frontend_dim),
                np.float32)
        if cfg.is_encdec:
            b["frontend"] = np.random.default_rng(step).normal(
                size=(args.batch, args.seq, cfg.frontend_dim)
            ).astype(np.float32)
        return b

    def wrapped(state, batch):
        p, o = state
        p, o, m = step_fn(p, o, batch)
        float(m["loss"])  # wait for the step: the watchdog times walls
        return (p, o), m

    loop = FaultTolerantLoop(
        wrapped, ckpt, FTConfig(checkpoint_every=args.ckpt_every))
    t0 = time.time()
    (params, opt_state), step = loop.run((params, opt_state), batch_fn,
                                         start, args.steps)
    dt = time.time() - t0
    # final report
    with torch.no_grad():
        loss = registry.loss_fn(params, batch_fn(step), cfg, device=device)
    print(f"done: {args.steps} steps in {dt:.1f}s "
          f"({args.steps / dt:.2f} it/s), final loss {float(loss):.4f}, "
          f"stragglers={loop.straggler_steps}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
