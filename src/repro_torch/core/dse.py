"""Hardware design-space exploration (paper §5.2, Fig. 13, Table 5).

Searches four hardware parameters — #PEs, L1 size, L2 size, NoC bandwidth —
under area/power constraints, optimizing throughput, energy, or EDP.
As in the paper, buffer sizes are not free axes: MAESTRO *reports* the
buffer requirement of each (dataflow × #PEs) design and the DSE places
exactly that amount (sweeping dataflow tile-size variants changes the
requirement).  Designs whose area/power exceed the budget are invalid.

The paper prunes invalid designs during its nested sweep (0.17M designs/s
effective).  Our evaluator is a batched closed form on the device, so we
evaluate *every* design and mask — cheaper per design than branchy
skipping, and embarrassingly parallel.  The area/power accounting and the
validity mask stay on the host in numpy, as in the reference.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Iterable, Sequence

import numpy as np
import torch

from .. import obs
from ..devices import resolve_device
from .dataflows import table3_for_layer
from .directives import Dataflow, TemporalMap
from .energy import (DEFAULT_AREA_POWER, AreaPowerModel, EYERISS_AREA_MM2,
                     EYERISS_POWER_MW)
from .tensor_analysis import LayerOp
from .vectorized import BatchStats, batched_evaluator


@dataclasses.dataclass
class DSEConfig:
    pe_range: Sequence[int] = tuple(range(8, 1025, 8))
    bw_range: Sequence[float] = tuple(float(b) for b in range(1, 129, 1))
    area_budget_mm2: float = EYERISS_AREA_MM2
    power_budget_mw: float = EYERISS_POWER_MW
    area_power: AreaPowerModel = DEFAULT_AREA_POWER
    batch: int = 65536

    def __post_init__(self) -> None:
        from ..resilience.errors import SpecError
        for f, lo in (("pe_range", 1), ("bw_range", 1e-9)):
            rng = getattr(self, f)
            if len(rng) == 0 or any(not v >= lo for v in rng):
                raise SpecError(f"{f} must be non-empty with entries "
                                f">= {lo}", field=f)
        for f in ("area_budget_mm2", "power_budget_mw"):
            if not getattr(self, f) > 0:
                raise SpecError(f"{f} must be > 0, "
                                f"got {getattr(self, f)!r}", field=f)
        if self.batch < 1:
            raise SpecError(f"batch must be >= 1, got {self.batch!r}",
                            field="batch")


@dataclasses.dataclass
class DSEResult:
    num_pes: np.ndarray
    noc_bw: np.ndarray
    stats: BatchStats
    area_mm2: np.ndarray
    power_mw: np.ndarray
    valid: np.ndarray
    n_evaluated: int
    n_valid: int
    elapsed_s: float
    tile_tag: str = "base"

    @property
    def rate_designs_per_s(self) -> float:
        return self.n_evaluated / max(self.elapsed_s, 1e-9)

    def _masked(self, col: np.ndarray, maximize: bool) -> int:
        v = np.where(self.valid, col, -np.inf if maximize else np.inf)
        return int(np.argmax(v) if maximize else np.argmin(v))

    def best(self, objective: str) -> dict[str, Any]:
        """objective in {'throughput', 'energy', 'edp'}."""
        s = self.stats
        idx = {
            "throughput": self._masked(np.asarray(s.throughput), True),
            "energy": self._masked(np.asarray(s.energy_pj), False),
            "edp": self._masked(np.asarray(s.edp), False),
        }[objective]
        return self.point(idx)

    def point(self, idx: int) -> dict[str, Any]:
        s = self.stats
        return {
            "num_pes": int(self.num_pes[idx]),
            "noc_bw": float(self.noc_bw[idx]),
            "runtime": float(np.asarray(s.runtime)[idx]),
            "energy_pj": float(np.asarray(s.energy_pj)[idx]),
            "throughput": float(np.asarray(s.throughput)[idx]),
            "edp": float(np.asarray(s.edp)[idx]),
            "l1_kb": float(np.asarray(s.l1_kb)[idx]),
            "l2_kb": float(np.asarray(s.l2_kb)[idx]),
            "util": float(np.asarray(s.util)[idx]),
            "bw_req": float(np.asarray(s.bw_req)[idx]),
            "area_mm2": float(self.area_mm2[idx]),
            "power_mw": float(self.power_mw[idx]),
            "valid": bool(self.valid[idx]),
            "tile_tag": self.tile_tag,
        }

    def pareto(self, x: str = "energy_pj", y: str = "throughput",
               y_max: bool = True) -> np.ndarray:
        """Indices of the valid pareto frontier (minimize x, max/min y)."""
        xs = np.asarray(getattr(self.stats, x))
        ys = np.asarray(getattr(self.stats, y))
        idx = np.where(self.valid)[0]
        order = idx[np.argsort(xs[idx])]
        front, best = [], -np.inf if y_max else np.inf
        for i in order:
            v = ys[i]
            if (v > best) if y_max else (v < best):
                front.append(i)
                best = v
        return np.asarray(front, dtype=np.int64)


def run_dse(op: LayerOp, df: Dataflow, cfg: DSEConfig | None = None,
            *, multicast: bool = True, spatial_reduction: bool = True,
            tile_tag: str = "base",
            device: str | torch.device | None = None) -> DSEResult:
    """Sweep the (PEs × NoC bw) grid for one (layer × dataflow) on
    ``device`` (``cuda`` unless the caller asks for another)."""
    cfg = cfg or DSEConfig()
    dev = resolve_device(device)
    f = batched_evaluator(op, df, multicast=multicast,
                          spatial_reduction=spatial_reduction, device=dev)
    pes_g, bw_g = np.meshgrid(np.asarray(cfg.pe_range, np.int64),
                              np.asarray(cfg.bw_range, np.float32),
                              indexing="ij")
    pes, bws = pes_g.ravel(), bw_g.ravel()
    obs.metrics().inc("dse.designs", len(pes))
    # warm up so the reported rate is the steady-state rate
    with obs.span("warmup", engine="dse-grid", op=op.name, df=df.name):
        _ = f(pes[:2], bws[:2]).cpu()
    feats_out = []
    with obs.span("device-pass", engine="dse-grid", op=op.name,
                  df=df.name, rows=len(pes)):
        t0 = time.perf_counter()
        for i in range(0, len(pes), cfg.batch):
            # chunks go to the device as int32 / float32; features come
            # back
            feats_out.append(f(pes[i:i + cfg.batch],
                               bws[i:i + cfg.batch]).cpu().numpy())
        if dev.type == "cuda":
            # the span and the rate time the card's work, not its enqueue
            torch.cuda.synchronize(dev)
        elapsed = time.perf_counter() - t0
    obs.metrics().observe("dse.grid_s", elapsed)
    feats = np.concatenate(feats_out, axis=0)
    stats = BatchStats.from_features(feats)

    sram_kb = np.asarray(stats.l1_kb) * pes + np.asarray(stats.l2_kb)
    area = cfg.area_power.area(pes, sram_kb, bws)
    power = cfg.area_power.power(pes, sram_kb, bws)
    valid = (area <= cfg.area_budget_mm2) & (power <= cfg.power_budget_mw)
    # total energy = dynamic (activity counts) + static (leakage × runtime)
    static = cfg.area_power.static_energy_pj(area, np.asarray(stats.runtime))
    stats.energy_pj = np.asarray(stats.energy_pj) + static
    stats.edp = stats.energy_pj * np.asarray(stats.runtime)
    return DSEResult(
        num_pes=pes, noc_bw=bws, stats=stats, area_mm2=area,
        power_mw=power, valid=np.asarray(valid), n_evaluated=len(pes),
        n_valid=int(np.sum(valid)), elapsed_s=elapsed, tile_tag=tile_tag)


# ----------------------------------------------------------------------
# Tile-size variants: the L1/L2 axes of the paper's 4-parameter search.
# ----------------------------------------------------------------------

def tile_variants(df: Dataflow, scales: Iterable[int] = (1, 2, 4),
                  dims: Iterable[str] = ("C", "K")) -> list[tuple[str, Dataflow]]:
    """Scale the concrete (non-symbolic) tile sizes of selected temporal
    maps — each variant implies a different buffer placement, which is how
    the DSE explores the L1/L2 axes.

    Symbolic (``Sz``/``FULL``) sizes are never scaled — they already mean
    "the whole dim".  The variant tag names only the dims actually scaled
    (e.g. ``x4[C]``); scales that scale nothing (every candidate directive
    symbolic) are dropped instead of silently emitting duplicates of the
    base dataflow under a misleading tag."""
    out: list[tuple[str, Dataflow]] = []
    seen: set[tuple] = set()
    for sc in scales:
        dirs = []
        scaled: list[str] = []
        for d in df.directives:
            if (sc != 1 and isinstance(d, TemporalMap) and d.dim in dims
                    and isinstance(d.size, int) and d.size > 0):
                dirs.append(TemporalMap(max(1, d.size * sc),
                                        max(1, d.offset * sc)
                                        if isinstance(d.offset, int)
                                        and d.offset > 0
                                        else d.offset, d.dim))
                scaled.append(d.dim)
            else:
                dirs.append(d)
        variant = Dataflow(df.name, tuple(dirs))
        if variant.directives in seen:
            continue
        seen.add(variant.directives)
        tag = "base" if sc == 1 or not scaled \
            else f"x{sc}[{','.join(scaled)}]"
        out.append((tag, variant))
    return out


def run_dse_full(op: LayerOp, dataflow_name: str,
                 cfg: DSEConfig | None = None,
                 scales: Iterable[int] = (1, 2, 4),
                 device: str | torch.device | None = None
                 ) -> list[DSEResult]:
    """The paper's full 4-parameter DSE: (PEs × bw) grid × tile variants."""
    dev = resolve_device(device)
    base = table3_for_layer(dataflow_name, op)
    results = []
    for tag, dfv in tile_variants(base, scales):
        results.append(run_dse(op, dfv, cfg, tile_tag=tag, device=dev))
    return results


def merge_results(results: Sequence[DSEResult]) -> dict[str, Any]:
    """Aggregate DSE statistics across variants (Fig. 13c style)."""
    n_eval = sum(r.n_evaluated for r in results)
    n_valid = sum(r.n_valid for r in results)
    elapsed = sum(r.elapsed_s for r in results)
    best = {}
    for obj in ("throughput", "energy", "edp"):
        cands = [r.best(obj) for r in results if r.n_valid]
        key = (lambda p: -p["throughput"]) if obj == "throughput" \
            else (lambda p: p["energy_pj"] if obj == "energy" else p["edp"])
        best[obj] = min(cands, key=key) if cands else None
    return {
        "n_evaluated": n_eval,
        "n_valid": n_valid,
        "elapsed_s": elapsed,
        "rate_designs_per_s": n_eval / max(elapsed, 1e-9),
        "best": best,
    }
