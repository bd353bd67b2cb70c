"""Family dispatch: one API over every family, the decoder LMs of
``transformer`` (dense; moe, a mixture of experts in place of each layer's
MLP; ssm, RWKV-6; hybrid, Zamba2's Mamba-2 layers and a shared attention
block) and the encoder-decoder of ``encdec`` (SeamlessM4T).

    specs(cfg)                                 -> ParamSpec tree
    loss_fn(params, batch, cfg)                -> scalar
    prefill(params, batch, cfg, max_len)       -> (last_logits, cache)
    decode_step(params, batch, cache, cfg)     -> (logits, cache)

Batch values that are tensors run where they lie; anything else (numpy
arrays, lists) goes to ``device``, ``cuda`` unless the caller names another.
A cache (a KV dict, the RWKV-6 ((state, carries), counter) tuple, the
hybrid ((Mamba-2 state, conv state), KV dict) tuple, or the encoder-decoder
{"self": KV dict, "cross": (K, V)} dict) is made by ``prefill`` on the
batch's device and stays there.
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..devices import input_device
from . import encdec, transformer
from .param import SpecTree, count_params, init_params


def _placed(batch: dict, device, name: str) -> dict:
    dev = input_device(batch["tokens"], device, name)
    return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}


def specs(cfg: ModelConfig) -> SpecTree:
    if cfg.is_encdec:
        return encdec.encdec_specs(cfg)
    return transformer.lm_specs(cfg)


def loss_fn(params, batch, cfg: ModelConfig, *,
            device: str | torch.device | None = None):
    family = encdec if cfg.is_encdec else transformer
    return family.loss_fn(params, _placed(batch, device, "loss_fn"), cfg)


def prefill(params, batch, cfg: ModelConfig, max_len: int, *,
            device: str | torch.device | None = None):
    family = encdec if cfg.is_encdec else transformer
    return family.prefill(params, _placed(batch, device, "prefill"), cfg,
                          max_len)


def decode_step(params, batch, cache, cfg: ModelConfig, *,
                device: str | torch.device | None = None):
    family = encdec if cfg.is_encdec else transformer
    return family.decode_step(
        params, _placed(batch, device, "decode_step"), cache, cfg)


__all__ = ["specs", "loss_fn", "prefill", "decode_step", "count_params",
           "init_params"]
