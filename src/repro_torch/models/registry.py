"""Family dispatch: one API over the ported decoder families, dense, moe
(a mixture of experts in place of each layer's MLP), ssm (RWKV-6) and
hybrid (Zamba2: Mamba-2 layers and a shared attention block); the
encoder-decoder family raises until its slice (ROADMAP.md, queue 1 item
7).

    specs(cfg)                                 -> ParamSpec tree
    loss_fn(params, batch, cfg)                -> scalar
    prefill(params, batch, cfg, max_len)       -> (last_logits, cache)
    decode_step(params, batch, cache, cfg)     -> (logits, cache)

Batch values that are tensors run where they lie; anything else (numpy
arrays, lists) goes to ``device``, ``cuda`` unless the caller names another.
A cache (a KV dict, the RWKV-6 ((state, carries), counter) tuple, or the
hybrid ((Mamba-2 state, conv state), KV dict) tuple) is made by
``prefill`` on the batch's device and stays there.
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..devices import input_device
from . import transformer
from .param import SpecTree, count_params, init_params


def _require_decoder(cfg: ModelConfig) -> None:
    if cfg.is_encdec:
        raise NotImplementedError(
            f"repro_torch: the encoder-decoder family ({cfg.name}) is not "
            "ported yet; see ROADMAP.md, queue 1 item 7")


def _placed(batch: dict, device, name: str) -> dict:
    dev = input_device(batch["tokens"], device, name)
    return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}


def specs(cfg: ModelConfig) -> SpecTree:
    _require_decoder(cfg)
    return transformer.lm_specs(cfg)


def loss_fn(params, batch, cfg: ModelConfig, *,
            device: str | torch.device | None = None):
    _require_decoder(cfg)
    return transformer.loss_fn(params, _placed(batch, device, "loss_fn"),
                               cfg)


def prefill(params, batch, cfg: ModelConfig, max_len: int, *,
            device: str | torch.device | None = None):
    _require_decoder(cfg)
    return transformer.prefill(params, _placed(batch, device, "prefill"),
                               cfg, max_len)


def decode_step(params, batch, cache, cfg: ModelConfig, *,
                device: str | torch.device | None = None):
    _require_decoder(cfg)
    return transformer.decode_step(
        params, _placed(batch, device, "decode_step"), cache, cfg)


__all__ = ["specs", "loss_fn", "prefill", "decode_step", "count_params",
           "init_params"]
