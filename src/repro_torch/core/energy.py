"""Energy / area / power tables (paper §5: Cacti 28 nm + RTL regression).

The paper multiplies MAESTRO's activity counts by per-access energies from a
CACTI simulation (28 nm, 2 KB L1 scratchpad, 1 MB shared L2) and fits
area/power of RTL building blocks (float/fixed MAC, bus, arbiter, scratchpads)
with linear (bus) and quadratic (arbiter) regressions.  The exact constants
are not published in the text, so the values below are *documented estimates*
calibrated to the same technology class and to the paper's anchor points
(Eyeriss-scale chip: 16 mm² / 450 mW budget binds at a few hundred PEs with
~100s of KB of SRAM).  Everything is replaceable (the paper notes Accelergy
can be swapped in); tests only rely on ordering properties, not absolutes.
"""
from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass(frozen=True)
class EnergyModel:
    """Per-event energies in pJ (28 nm class).

    Reference capacities follow the paper's CACTI setup: the L1 cost is for
    a 2 KB scratchpad, the L2 cost for a 1 MB shared buffer.  Access energy
    scales ~sqrt(capacity) with the placed buffer size (CACTI wordline/
    bitline scaling), which is what makes the DSE's energy-vs-throughput
    trade-off non-trivial (Table 5)."""
    mac: float = 0.56            # 16-bit MAC
    l1_read: float = 1.12        # 2 KB scratchpad read
    l1_write: float = 1.12
    l2_read: float = 16.6        # 1 MB shared buffer read
    l2_write: float = 16.6
    noc_hop: float = 0.8         # per element per NoC traversal
    l1_ref_kb: float = 2.0
    l2_ref_kb: float = 1024.0

    def l1_scale(self, l1_kb: Any) -> Any:
        return _sqrt_scale(l1_kb, self.l1_ref_kb)

    def l2_scale(self, l2_kb: Any) -> Any:
        return _sqrt_scale(l2_kb, self.l2_ref_kb)

    def rel(self) -> dict[str, float]:
        """Relative table normalized to one MAC (Fig. 12 style)."""
        return {
            "mac": 1.0,
            "l1": self.l1_read / self.mac,
            "l2": self.l2_read / self.mac,
            "noc": self.noc_hop / self.mac,
        }


def _sqrt_scale(kb: Any, ref_kb: float) -> Any:
    """sqrt-capacity scaling with a floor so tiny buffers don't get free."""
    if isinstance(kb, (int, float)):
        return max(kb / ref_kb, 0.04) ** 0.5
    import torch
    return torch.clamp(kb / ref_kb, min=0.04) ** 0.5


@dataclasses.dataclass(frozen=True)
class AreaPowerModel:
    """RTL-regression-style models (paper §5.2).

    area(design)  = pes·pe_area + sram_kb·sram_area_kb
                  + bus: linear in width, arbiter: quadratic in endpoints
    power(design) = analogous with per-unit powers.
    """
    pe_area_mm2: float = 0.014        # MAC + control + L0 regs
    sram_area_mm2_per_kb: float = 0.006
    bus_area_mm2_per_lane: float = 0.004     # per element/cycle of BW
    arbiter_area_coeff: float = 1.2e-6       # × endpoints²

    pe_power_mw: float = 0.9
    sram_power_mw_per_kb: float = 0.18
    bus_power_mw_per_lane: float = 1.3
    arbiter_power_coeff: float = 6.0e-5      # × endpoints²

    # Static (leakage) energy: pJ per cycle per mm² @ 28 nm / 1 GHz.  This
    # is what makes slow low-PE designs lose on *energy*, not just runtime
    # (the paper's energy-optimal KC-P design keeps 80% of the PEs of the
    # throughput-optimal one rather than collapsing to a minimal array).
    static_pj_per_cycle_mm2: float = 2.0

    def static_energy_pj(self, area_mm2: Any, runtime_cycles: Any) -> Any:
        return self.static_pj_per_cycle_mm2 * area_mm2 * runtime_cycles

    def area(self, pes: Any, sram_kb: Any, noc_bw: Any) -> Any:
        return (pes * self.pe_area_mm2
                + sram_kb * self.sram_area_mm2_per_kb
                + noc_bw * self.bus_area_mm2_per_lane
                + (pes * pes) * self.arbiter_area_coeff)

    def power(self, pes: Any, sram_kb: Any, noc_bw: Any) -> Any:
        return (pes * self.pe_power_mw
                + sram_kb * self.sram_power_mw_per_kb
                + noc_bw * self.bus_power_mw_per_lane
                + (pes * pes) * self.arbiter_power_coeff)


DEFAULT_ENERGY = EnergyModel()
DEFAULT_AREA_POWER = AreaPowerModel()

# Paper's DSE budget = reported Eyeriss chip envelope.
EYERISS_AREA_MM2 = 16.0
EYERISS_POWER_MW = 450.0
