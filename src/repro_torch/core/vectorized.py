"""Batched twin of the faithful engine.

The paper's DSE sweeps hardware parameters (#PEs, NoC bandwidth) holding
(layer × dataflow) fixed.  Because the analysis in ``model.py`` is written
against the backend facade, the *same code* runs with the hardware
parameters as (n,)-shaped tensors: layer dims, directive sizes, temporal
trip counts and the iteration-case structure stay static Python ints
(hybrid backend), while everything touched by ``num_pes`` / ``noc_bw`` is a
tensor op over the whole batch.  No ``vmap`` is needed: one pass of the
analysis evaluates every design point of the batch.

Output is a flat, fixed-shape feature vector per design point so the DSE
can stack millions of them.  Dtypes follow the reference with x64 off:
``num_pes`` int32, ``noc_bw`` and the features float32.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ..devices import resolve_device
from .cluster_analysis import hybrid_backend
from .directives import Dataflow
from .model import analyze
from .performance import HWConfig
from .tensor_analysis import LayerOp

# Feature vector layout produced by the batched evaluator.
FEATURES = ("runtime", "energy_pj", "macs", "l1_kb", "l2_kb", "util",
            "bw_req", "throughput", "edp")


def _col(v, n: int, device) -> torch.Tensor:
    """One feature as float32[n]: tensors are cast, static values (Python
    numbers the hardware parameters never touched) broadcast."""
    return torch.as_tensor(v, dtype=torch.float32, device=device).expand(n)


def _features(s, n: int, device) -> torch.Tensor:
    """Pack a Stats object into the fixed FEATURES columns -> float32[n, F]."""
    runtime = _col(s.runtime, n, device)
    energy = _col(s.energy_pj, n, device)
    macs = _col(s.total_macs, n, device)
    return torch.stack([
        runtime,
        energy,
        macs,
        _col(s.l1_req_kb, n, device),
        _col(s.l2_req_kb, n, device),
        _col(s.utilization, n, device),
        _col(s.peak_bw.get(0, 0), n, device),
        macs / runtime,
        energy * runtime,
    ], dim=-1)


def stats_vector(op: LayerOp, df: Dataflow, hw: HWConfig) -> torch.Tensor:
    """A batch of design points (``hw.num_pes`` int32[n], ``hw.noc_bw``
    float32[n]) -> float32[n, F]."""
    xp = hybrid_backend()
    n = hw.num_pes.shape[0]
    return _features(analyze(op, df, hw, xp=xp), n, hw.num_pes.device)


def batched_evaluator(op: LayerOp, df: Dataflow, *, multicast: bool = True,
                      spatial_reduction: bool = True,
                      noc_latency: float = 2.0, macs_per_pe: int = 1,
                      device: str | torch.device | None = None) -> Callable:
    """Returns ``f(num_pes[i], noc_bw[i]) -> features[i, F]`` on ``device``
    (``cuda`` unless the caller asks for another).

    The returned callable evaluates the full MAESTRO analysis for every
    design point of its batch; inputs are moved to ``device`` as int32 /
    float32."""
    dev = resolve_device(device)

    def eval_batch(num_pes, noc_bw) -> torch.Tensor:
        hw = HWConfig(
            num_pes=torch.as_tensor(num_pes, dtype=torch.int32,
                                    device=dev).reshape(-1),
            noc_bw=torch.as_tensor(noc_bw, dtype=torch.float32,
                                   device=dev).reshape(-1),
            noc_latency=noc_latency, multicast=multicast,
            spatial_reduction=spatial_reduction, macs_per_pe=macs_per_pe)
        return stats_vector(op, df, hw)

    return eval_batch


@dataclasses.dataclass
class BatchStats:
    """Columnar stats for a batch of design points."""
    runtime: Any
    energy_pj: Any
    macs: Any
    l1_kb: Any
    l2_kb: Any
    util: Any
    bw_req: Any
    throughput: Any
    edp: Any

    @classmethod
    def from_features(cls, feats) -> "BatchStats":
        cols = {name: feats[..., i] for i, name in enumerate(FEATURES)}
        return cls(**{
            "runtime": cols["runtime"], "energy_pj": cols["energy_pj"],
            "macs": cols["macs"], "l1_kb": cols["l1_kb"],
            "l2_kb": cols["l2_kb"], "util": cols["util"],
            "bw_req": cols["bw_req"], "throughput": cols["throughput"],
            "edp": cols["edp"]})


def evaluate_grid(op: LayerOp, df: Dataflow, num_pes, noc_bw,
                  **kw) -> BatchStats:
    """Evaluate (layer × dataflow) over arrays of hardware design points."""
    f = batched_evaluator(op, df, **kw)
    return BatchStats.from_features(f(num_pes, noc_bw))
