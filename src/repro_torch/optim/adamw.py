"""AdamW with float32 moment states, as the JAX package's
``optim/adamw.py``.

Params keep their dtype; each update is computed in float32, op for op as
the reference (the clip scale, ``b1c``/``b2c`` bias corrections, ``eps``
added after the square root, then weight decay, then ``p - lr * step``)
and cast back.  Where the reference returns new trees, the port updates
the params and the moments in place under ``torch.no_grad()``: one copy of
each lives on the card.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..tree import leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup + cosine decay; ``step`` a number or a 0-d tensor."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = (step - cfg.warmup_steps) / max(
        cfg.total_steps - cfg.warmup_steps, 1)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init_state(params) -> dict:
    def zeros_like_f32(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    dev = leaves(params)[0].device
    return {
        "mu": tree_map(zeros_like_f32, params),
        "nu": tree_map(zeros_like_f32, params),
        "count": torch.zeros((), dtype=torch.int32, device=dev),
    }


def global_norm(tree) -> torch.Tensor:
    total = 0
    for leaf in leaves(tree):
        total = total + torch.sum(leaf.float() ** 2)
    return torch.sqrt(total)


@torch.no_grad()
def apply_updates(params, grads, state, cfg: AdamWConfig):
    """Returns (params, new_state, metrics): ``params`` and the moments
    updated in place, ``metrics`` {"grad_norm", "lr"} as 0-d float32
    tensors on the params' device.  Extra state slots (the compression's
    ``error_feedback``) are kept."""
    count = state["count"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0) if cfg.grad_clip else 1.0
    lr = schedule(cfg, count)
    b1c = 1 - cfg.b1 ** count.to(torch.float32)
    b2c = 1 - cfg.b2 ** count.to(torch.float32)
    for p, g, mu, nu in zip(leaves(params), leaves(grads),
                            leaves(state["mu"]), leaves(state["nu"])):
        g = g.float() * scale
        mu.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        nu.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        step_ = (mu / b1c) / (torch.sqrt(nu / b2c) + cfg.eps)
        step_ = step_ + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * step_)
    new_state = {**state, "count": count}
    return params, new_state, {"grad_norm": gnorm, "lr": lr}
