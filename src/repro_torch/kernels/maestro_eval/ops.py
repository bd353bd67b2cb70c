"""Dispatching wrapper for the DSE-evaluation kernel."""
from __future__ import annotations

import torch

from ...devices import input_device
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
    dev = input_device(pes, device, "dse_eval")
    pes = torch.as_tensor(pes, dtype=torch.int32, device=dev)
    bw = torch.as_tensor(bw, dtype=torch.float32, device=dev)
    return maestro_eval(pes, bw, tables=tables)
