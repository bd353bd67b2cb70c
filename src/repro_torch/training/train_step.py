"""Train-step builder: loss -> grads -> (optional int8 compression) ->
AdamW, with microbatch gradient accumulation, as the JAX package's
``training/train_step.py``.

Params are leaf tensors that require grad; the gradient is
``torch.autograd.grad`` of ``registry.loss_fn`` (on the card, the
attention's and the linear scan's backwards are hand-written kernels).
Microbatches are a Python loop that sums float32 gradients, where the
reference scans.  The update is in place (``optim.adamw``).  The
abstract (shape-only) train state waits for the mesh layer.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..configs.base import ModelConfig
from ..devices import resolve_device
from ..models import registry
from ..optim import adamw
from ..tree import leaves, tree_map, unflatten
from .grad_compression import compress_decompress


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1
    compress_grads: bool = False
    compress_bits: int = 8
    opt: adamw.AdamWConfig = dataclasses.field(
        default_factory=adamw.AdamWConfig)


def _split_micro(batch: dict, m: int) -> dict:
    def r(x):
        b = x.shape[0]
        assert b % m == 0, f"batch {b} not divisible by microbatches {m}"
        return x.reshape(m, b // m, *x.shape[1:])
    return {k: r(v) for k, v in batch.items()}


def make_train_step(cfg: ModelConfig, tc: TrainConfig, *,
                    device: str | torch.device | None = None) -> Callable:
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics), metrics {"loss", "grad_norm", "lr"} as 0-d float32 tensors.
    Batches that are not tensors go to ``device``, ``cuda`` unless the
    caller names another."""
    dev = resolve_device(device)

    def value_and_grad(params, batch):
        flat = leaves(params)
        for p in flat:
            if not p.requires_grad:
                p.requires_grad_(True)
        loss = registry.loss_fn(params, batch, cfg, device=dev)
        grads = torch.autograd.grad(loss, flat)
        return loss.detach(), unflatten(params, grads)

    def train_step(params, opt_state, batch):
        if tc.microbatches > 1:
            micro = _split_micro(batch, tc.microbatches)
            gsum, lsum = None, 0.0
            for i in range(tc.microbatches):
                loss, grads = value_and_grad(
                    params, {k: v[i] for k, v in micro.items()})
                gsum = tree_map(lambda g: g.float(), grads) if gsum is None \
                    else tree_map(lambda a, g: a + g.float(), gsum, grads)
                lsum = lsum + loss
            loss = lsum / tc.microbatches
            grads = tree_map(lambda g: g / tc.microbatches, gsum)
        else:
            loss, grads = value_and_grad(params, batch)

        if tc.compress_grads:
            grads, opt_state = compress_decompress(
                grads, opt_state, bits=tc.compress_bits)

        params, opt_state, om = adamw.apply_updates(
            params, grads, opt_state, tc.opt)
        return params, opt_state, {"loss": loss, **om}

    return train_step


def init_train_state(cfg: ModelConfig, tc: TrainConfig, seed: int = 0,
                     device: str | torch.device | None = None):
    """(params, opt_state) on ``device`` (``cuda`` unless the caller names
    another): params drawn from ``seed`` as leaf tensors that require
    grad, AdamW's float32 moments and, with ``compress_grads``, the error
    feedback."""
    from ..models.param import init_params
    params = init_params(registry.specs(cfg), seed, device)
    for p in leaves(params):
        p.requires_grad_(True)
    opt_state = adamw.init_state(params)
    if tc.compress_grads:
        opt_state["error_feedback"] = tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), params)
    return params, opt_state
