"""Dispatching wrapper for the DSE-evaluation kernel."""
from __future__ import annotations

import torch

from ...devices import resolve_device
from .maestro_eval import maestro_eval
from .tables import build_tables


def dse_eval(pes, bw, *, op=None, dataflow=None, tables=None,
             device: str | torch.device | None = None) -> torch.Tensor:
    """Features float32[N, 5] for design points (pes, bw).

    Runs where the inputs lie: CUDA tensors launch the CUDA kernel, CPU
    tensors take the plain version (``maestro_eval`` decides).  Inputs that
    are not tensors are moved to ``device``, ``cuda`` unless the caller
    asks for another; tensors on another device than the ``device`` named
    raise.  There is no fallback: a CUDA input the kernel cannot take
    raises."""
    if tables is None:
        tables = build_tables(op, dataflow)
    if isinstance(pes, torch.Tensor):
        dev = pes.device
        want = None if device is None else torch.device(device)
        if want is not None and (want.type != dev.type or want.index
                                 not in (None, dev.index)):
            raise ValueError(f"dse_eval: inputs lie on {dev}, but "
                             f"device={want} was asked for")
    else:
        dev = resolve_device(device)
    pes = torch.as_tensor(pes, dtype=torch.int32, device=dev)
    bw = torch.as_tensor(bw, dtype=torch.float32, device=dev)
    return maestro_eval(pes, bw, tables=tables)
