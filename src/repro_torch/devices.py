"""The port's device rule: entry points run on ``cuda`` unless the caller
names another device, and never fall back to the CPU on their own."""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means ``cuda``; a CUDA device on a machine without one
    raises instead of quietly running elsewhere."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run on the CPU")
    return dev


def input_device(x, device: str | torch.device | None,
                 name: str) -> torch.device:
    """Where an entry point given ``x`` runs: a tensor's own device (a
    ``device`` named beside it must agree, else ``ValueError``), anything
    else ``resolve_device(device)``."""
    if not isinstance(x, torch.Tensor):
        return resolve_device(device)
    dev = x.device
    want = None if device is None else torch.device(device)
    if want is not None and (want.type != dev.type or want.index
                             not in (None, dev.index)):
        raise ValueError(f"{name}: inputs lie on {dev}, but "
                         f"device={want} was asked for")
    return dev
