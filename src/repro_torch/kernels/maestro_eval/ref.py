"""Oracle: the shared closed form evaluated as plain PyTorch (no kernel)."""
from __future__ import annotations

import torch

from .maestro_eval import closed_form_features
from .tables import EvalTables


def maestro_eval_ref(pes, bw, *, tables: EvalTables) -> torch.Tensor:
    """Plain version on whatever device ``pes`` lies on (the CPU for
    numpy or list input)."""
    pes = torch.as_tensor(pes, dtype=torch.int32)
    bw = torch.as_tensor(bw, dtype=torch.float32, device=pes.device)
    return closed_form_features(pes, bw, tables)
