"""Performance analysis (PA) engine pieces: the abstract hardware model and
the per-case delay math (paper §4.2, Fig. 8).

The NoC is the paper's *pipe model*: a bandwidth (elements/cycle) and an
average latency (cycles).  Communication delay of V elements is
``ceil(V / bw) + latency`` — the pipelining effect of packet-switched NoCs.
Double buffering makes the steady-state step delay
``max(ingress, compute, egress)``; the initialization case is serial
(``ingress + compute + egress``).
"""
from __future__ import annotations

import dataclasses
from typing import Any

from .cluster_analysis import Backend, _t_maximum


@dataclasses.dataclass(frozen=True)
class HWConfig:
    """Abstract accelerator model (paper Fig. 2).

    ``noc_bw`` is in data elements/cycle; ``noc_latency`` in cycles.
    ``multicast``/``spatial_reduction`` gate the hardware support of Table 2
    (their absence is the Table 5 ablation).  ``l1_kb``/``l2_kb`` of ``None``
    mean "place exactly what MAESTRO reports" (the paper's DSE behaviour);
    concrete values turn into validity constraints.

    The network-schedule fields (``repro.netspace``) model what single-layer
    analysis cannot see: ``dram_bw``/``dram_energy_pj`` price the off-chip
    boundary that fused layer stacks avoid crossing for intermediate
    activations, and ``reconfig_latency`` is the fixed pipeline cost of
    switching the PE array between differing mappings (on top of the
    L1/L2 drain/refill traffic, see :func:`reconfig_cycles`).
    """
    num_pes: Any
    noc_bw: Any = 32.0
    noc_latency: Any = 2.0
    macs_per_pe: int = 1
    multicast: bool = True
    spatial_reduction: bool = True
    dtype_bytes: int = 2
    l1_kb: Any = None
    l2_kb: Any = None
    freq_mhz: float = 1000.0
    dram_bw: Any = 16.0          # off-chip elements/cycle (DDR-class)
    dram_energy_pj: float = 100.0  # per element off-chip transfer (28 nm)
    reconfig_latency: Any = 0.0  # fixed cycles per dataflow switch

    def replace(self, **kw) -> "HWConfig":
        return dataclasses.replace(self, **kw)


def comm_delay(xp: Backend, volume: Any, hw: HWConfig) -> Any:
    """Pipe-model delay for ``volume`` elements (0 volume → 0 delay)."""
    d = xp.ceil_div(volume, hw.noc_bw) + hw.noc_latency
    return xp.where(volume > 0, d, 0)


def compute_delay(xp: Backend, psums: Any, hw: HWConfig) -> Any:
    return xp.ceil_div(psums, hw.macs_per_pe)


def log2_ceil(xp: Backend, x: Any) -> Any:
    if isinstance(x, int):
        return max(0, (max(x, 1) - 1)).bit_length()
    import torch
    xf = _t_maximum(x, 1).to(torch.float32)
    return torch.ceil(torch.log2(xf)).to(torch.int32)


def reduction_fwd_delay(xp: Backend, active_units: Any, hw: HWConfig,
                        enabled: bool) -> Any:
    """Adder-tree spatial-reduction latency (paper GetPSumFwdDelay):
    ``ceil(log2(n))`` stages; zero when the level has no spatial reduction."""
    if not enabled:
        return 0
    return log2_ceil(xp, active_units)


def dram_cycles(xp: Backend, volume: Any, hw: HWConfig) -> Any:
    """Off-chip transfer delay for ``volume`` elements at ``hw.dram_bw``
    (0 volume → 0 delay) — the boundary cost a fused layer stack saves."""
    d = xp.ceil_div(volume, hw.dram_bw)
    return xp.where(volume > 0, d, 0)


def reconfig_cycles(xp: Backend, hw: HWConfig, *, l1_prev_kb: Any,
                    l2_prev_kb: Any, l1_next_kb: Any, l2_next_kb: Any,
                    num_pes: Any | None = None) -> Any:
    """Cycles to switch the PE array between two differing mappings: the
    outgoing mapping's L1/L2 working set drains and the incoming one's
    refills over the NoC, plus the fixed control overhead
    ``hw.reconfig_latency``.  L1 is per-PE (drained across ``num_pes``
    units); volumes convert from the KB the analysis reports."""
    pes = hw.num_pes if num_pes is None else num_pes
    kb = (l1_prev_kb + l1_next_kb) * pes + l2_prev_kb + l2_next_kb
    elems = kb * 1024.0 / hw.dtype_bytes
    return hw.reconfig_latency + xp.ceil_div(elems, hw.noc_bw)
