"""Joint mapping × hardware co-DSE (the paper's full 480M-design search,
both axes at once) — the port of ``repro.mapspace.codse``.

``co_search`` runs the mapping search at a reference hardware point, then
crosses the top-k distinct mappings with the (PEs × NoC bandwidth) grid in
a SINGLE merged frontier: the hardware point is a per-row operand of the
same universal evaluator the mapping search already warmed
(``mapspace.universal``), so mapping genes and hardware axes are one
operand space, not two staged searches.  Area/power budgets and leakage
energy follow ``core.dse.run_dse`` exactly, and Table 3 baselines can ride
along (through ``run_dse``'s batched engine) so the frontier directly
answers "what does mapping search buy over the paper's fixed dataflows?".
Everything runs on ``device`` (``cuda`` unless the caller asks for
another) and raises without a GPU rather than run elsewhere.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Sequence

import numpy as np
import torch

from .. import obs
from ..core.dataflows import table3_for_layer
from ..core.dse import DSEConfig, DSEResult, run_dse
from ..core.tensor_analysis import LayerOp
from ..core.vectorized import FEATURES, BatchStats, HWTail
from ..devices import resolve_device
from ..resilience import (SweepCheckpoint, array_hash, check_cancel,
                          fault_point, pack_top, unpack_top)
from .search import OBJECTIVES, SearchResult, search
from .space import (MapSpace, genes_from_points, point_dataflow,
                    sample_genes)
from .universal import (evaluate_genes, evaluate_points_universal,
                        pareto_front)


@dataclasses.dataclass
class JointSweepResult:
    """One paper-scale sweep over (gene matrix x hardware grid) on the
    device.  The full cross product runs through the gene pipeline's
    reduction tail — area/power/leakage accounting on the device, only
    top-k winners and the (energy, throughput) frontier come back, never
    an (n, F) feature matrix."""
    n_designs: int
    n_mappings: int
    n_hw: int
    n_valid: int
    objective: str
    top: list[dict[str, Any]]             # best designs (mapping + hw)
    pareto: list[dict[str, Any]]          # exact valid-design frontier
    elapsed_s: float
    compile_s: float
    n_compiles: int
    n_devices: int = 1

    @property
    def designs_per_s(self) -> float:
        """End-to-end rate excluding the first pass at each evaluator
        shape (the port's warm-up) — the number to hold against the
        paper's 480M designs at 0.17M/s."""
        return self.n_designs / max(self.elapsed_s - self.compile_s, 1e-9)


@dataclasses.dataclass
class CoDSEResult:
    search: SearchResult
    dse: list[tuple[str, DSEResult]]      # (mapping label, hw sweep)
    pareto: list[dict[str, Any]]          # merged frontier, energy-sorted
    best: dict[str, dict[str, Any] | None]  # per objective, across all
    n_evaluated: int                      # mappings + joint hw designs
    elapsed_s: float
    n_compiles: int = 0                   # warm-up passes, joint sweep
    joint: JointSweepResult | None = None  # paper-scale gene sweep


def merged_pareto(results: Sequence[tuple[str, DSEResult]],
                  x: str = "energy_pj", y: str = "throughput"
                  ) -> list[dict[str, Any]]:
    """Valid-design Pareto frontier (min x, max y) across several hardware
    sweeps; each frontier point carries its mapping label."""
    pts = []
    for label, r in results:
        xs = np.asarray(getattr(r.stats, x))
        ys = np.asarray(getattr(r.stats, y))
        for i in np.where(r.valid)[0]:
            pts.append((float(xs[i]), float(ys[i]), label, r, int(i)))
    pts.sort(key=lambda t: (t[0], -t[1]))
    front: list[dict[str, Any]] = []
    best_y = -np.inf
    for xv, yv, label, r, i in pts:
        if yv > best_y:
            best_y = yv
            front.append({"mapping": label, x: xv, y: yv, **r.point(i)})
    return front


def hw_grid(cfg: DSEConfig) -> tuple[np.ndarray, np.ndarray]:
    """The flattened (PEs, NoC bandwidth) design grid of a
    :class:`DSEConfig` — the hardware axis every joint sweep (per-mapping,
    paper-scale gene, and netspace's network-level co-search) crosses its
    mapping rows with."""
    pes_g, bw_g = np.meshgrid(np.asarray(cfg.pe_range, np.int64),
                              np.asarray(cfg.bw_range, np.float32),
                              indexing="ij")
    return pes_g.ravel(), bw_g.ravel()


def _joint_sweep(op: LayerOp, space: MapSpace, point, label: str,
                 cfg: DSEConfig, *, block: int, multicast: bool,
                 spatial_reduction: bool,
                 device: str | torch.device | None = None
                 ) -> tuple[DSEResult, int]:
    """One mapping × full (PEs × bw) grid through the universal evaluator
    on ``device`` — hardware as operands, identical budget/leakage
    accounting to ``core.dse.run_dse``."""
    pes, bws = hw_grid(cfg)
    t0 = time.perf_counter()
    feats, run = evaluate_points_universal(
        op, space, [point] * len(pes), num_pes=pes, noc_bw=bws,
        block=block, multicast=multicast,
        spatial_reduction=spatial_reduction, device=device)
    elapsed = time.perf_counter() - t0
    stats = BatchStats.from_features(feats)

    sram_kb = np.asarray(stats.l1_kb) * pes + np.asarray(stats.l2_kb)
    area = cfg.area_power.area(pes, sram_kb, bws)
    power = cfg.area_power.power(pes, sram_kb, bws)
    valid = (area <= cfg.area_budget_mm2) & (power <= cfg.power_budget_mw)
    static = cfg.area_power.static_energy_pj(area, np.asarray(stats.runtime))
    stats.energy_pj = np.asarray(stats.energy_pj) + static
    stats.edp = stats.energy_pj * np.asarray(stats.runtime)
    return DSEResult(
        num_pes=pes, noc_bw=bws, stats=stats, area_mm2=area,
        power_mw=power, valid=np.asarray(valid), n_evaluated=len(pes),
        n_valid=int(np.sum(valid)), elapsed_s=elapsed,
        tile_tag=label), run.n_compiles


def joint_sweep(op: LayerOp, space: MapSpace, genes: np.ndarray,
                cfg: DSEConfig | None = None, *, objective: str = "edp",
                k: int = 16, block: int = 8192,
                n_devices: int | None = None,
                chunk_designs: int = 1 << 18,
                multicast: bool = True, spatial_reduction: bool = True,
                ckpt: SweepCheckpoint | None = None,
                device: str | torch.device | None = None
                ) -> JointSweepResult:
    """Paper-scale joint DSE on ``device``: every row of ``genes`` crossed
    with the full (PEs x NoC bandwidth) grid of ``cfg`` — ``len(genes) *
    |grid|`` designs — streamed through the gene pipeline with the
    hardware accounting of ``core.dse.run_dse`` (SRAM placement,
    area/power budgets, leakage energy) in its reduction tail.  The cross
    product is never materialized: design chunks gather their mapping row
    and hardware point from the flat design index on the fly.

    This is the reproduction of the paper's 480M-design search shape:
    mapping and hardware axes in ONE operand space, two evaluators (1- and
    2-level families), any count of CUDA devices.

    With ``ckpt`` the sweep persists its accumulators (design-chunk
    cursor, top entries, frontier candidates) after every completed
    design chunk, so a killed 10M+-design sweep resumes from the last
    chunk boundary bit-identically; the in-flight inner chunk restarts
    from scratch (design chunks are the durable unit)."""
    t0 = time.perf_counter()
    cfg = cfg or DSEConfig()
    genes = np.asarray(genes, np.int64)
    pes, bws = hw_grid(cfg)
    pes = pes.astype(np.float32)
    m, h = genes.shape[0], pes.shape[0]
    n = m * h
    col, maximize = OBJECTIVES[objective]
    tail = HWTail(area_power=cfg.area_power,
                  area_budget_mm2=cfg.area_budget_mm2,
                  power_budget_mw=cfg.power_budget_mw)
    top_entries: list[tuple[float, int, np.ndarray]] = []
    front_cands: list[dict[str, Any]] = []
    n_valid = 0
    n_compiles = 0
    compile_s = 0.0
    n_dev = 1

    start_lo = 0
    ckpt_meta: dict | None = None
    if ckpt is not None:
        ckpt_meta = {"key": ckpt.key, "n": int(n), "m": int(m),
                     "h": int(h), "chunk_designs": int(chunk_designs),
                     "block": int(block), "objective": objective,
                     "k": int(k), "content": array_hash(genes, pes, bws)}
        st = ckpt.load(ckpt_meta)
        if st is not None:
            start_lo = int(st["cursor"])
            n_valid = int(st["n_valid"])
            top_entries.extend(unpack_top(st))
            for r, e, t in zip(st["front_rows"], st["front_e"],
                               st["front_t"]):
                front_cands.append({"row": int(r), "energy_pj": float(e),
                                    "throughput": float(t)})

    for lo in range(start_lo, n, chunk_designs):
        check_cancel("design-chunk")
        fault_point("design-chunk")
        hi = min(lo + chunk_designs, n)
        flat = np.arange(lo, hi, dtype=np.int64)
        gi, hwi = flat // h, flat % h
        # container span only (inner compile/device-pass spans carry the
        # phase attribution) — names one (design x mapping) tile in a
        # request's trace
        with obs.span("design-chunk", lo=int(lo), rows=int(hi - lo)):
            res = evaluate_genes(
                op, space, genes[gi], objective=col, maximize=maximize,
                k=k, num_pes=pes[hwi], noc_bw=bws[hwi], block=block,
                n_devices=n_devices, multicast=multicast,
                spatial_reduction=spatial_reduction, return_vals=False,
                pareto=True, hw_tail=tail, device=device)
        n_valid += res.run.n_valid
        n_compiles += res.run.n_compiles
        compile_s += res.run.compile_s
        n_dev = max(n_dev, res.run.n_devices)
        for t in res.top:
            if np.isfinite(t["value"]):
                top_entries.append((t["value"], lo + t["row"],
                                    t["feats"]))
        for p in res.pareto:
            front_cands.append({**p, "row": lo + p["row"]})
        if ckpt is not None:
            # a design chunk is minutes of device work at paper scale —
            # checkpoint unconditionally at every chunk boundary
            ckpt.save(
                {"cursor": hi, "n_valid": n_valid,
                 **pack_top(top_entries),
                 "front_rows": np.array(
                     [c["row"] for c in front_cands], np.int64),
                 "front_e": np.array(
                     [c["energy_pj"] for c in front_cands], np.float64),
                 "front_t": np.array(
                     [c["throughput"] for c in front_cands], np.float64)},
                ckpt_meta)
    if ckpt is not None:
        ckpt.clear()               # completed: the checkpoint is spent

    def design(row: int, feats: np.ndarray | None) -> dict[str, Any]:
        gi, hwi = row // h, row % h
        d = {"point": tuple(int(x) for x in genes[gi]),
             "num_pes": int(pes[hwi]), "noc_bw": float(bws[hwi])}
        if feats is not None:
            d.update({name: float(feats[i])
                      for i, name in enumerate(FEATURES)})
            sram = d["l1_kb"] * d["num_pes"] + d["l2_kb"]
            d["area_mm2"] = float(cfg.area_power.area(
                d["num_pes"], sram, d["noc_bw"]))
            d["power_mw"] = float(cfg.area_power.power(
                d["num_pes"], sram, d["noc_bw"]))
        return d

    top_entries.sort(key=lambda e: (e[0], e[1]))
    top = []
    for v, row, feats in top_entries[:k]:
        d = design(row, feats)
        d["value"] = -v if maximize else v
        top.append(d)
    front = [dict(design(c["row"], None), energy_pj=c["energy_pj"],
                  throughput=c["throughput"])
             for c in pareto_front(front_cands)]
    return JointSweepResult(
        n_designs=n, n_mappings=m, n_hw=h, n_valid=n_valid,
        objective=objective, top=top, pareto=front,
        elapsed_s=time.perf_counter() - t0, compile_s=compile_s,
        n_compiles=n_compiles, n_devices=n_dev)


def co_search(op: LayerOp, objective: str = "edp",
              mapping_budget: int = 2000, top_k: int = 4,
              cfg: DSEConfig | None = None, **kwargs) -> CoDSEResult:
    """Joint mapping × hardware co-DSE — a thin wrapper over the
    declarative session path (``repro_torch.api``); forwards verbatim to
    :func:`co_search_impl` (bit-equal by construction, see
    ``tests/test_torch_api.py``).  Runs on ``cuda`` unless ``device``
    names another device."""
    from ..api.session import default_session
    return default_session().run_co_search(
        op, objective=objective, mapping_budget=mapping_budget,
        top_k=top_k, cfg=cfg, **kwargs)


def co_search_impl(op: LayerOp, objective: str = "edp",
                   mapping_budget: int = 2000, top_k: int = 4,
                   cfg: DSEConfig | None = None, *, num_pes: int = 256,
                   noc_bw: float = 32.0, seed: int = 0,
                   space: MapSpace | None = None,
                   include_table3: Sequence[str] = (),
                   cache_dir: str | None = None,
                   joint_genes: int = 0, joint_block: int = 8192,
                   cache_extra: str = "",
                   ckpt_dir: str | None = None,
                   search_kwargs: dict[str, Any] | None = None,
                   device: str | torch.device | None = None
                   ) -> CoDSEResult:
    """Joint DSE in one frontier: mapping search at ``(num_pes, noc_bw)``,
    then the hardware grid for each of the ``top_k`` distinct found
    mappings — evaluated through the same universal executable with the
    hardware point as a per-row operand (no staging, no re-compilation) —
    plus any requested Table 3 baselines, merged into one Pareto
    frontier.  Every pass runs on ``device`` (``cuda`` unless the caller
    asks for another).

    ``joint_genes > 0`` additionally runs the paper-scale sweep
    (:func:`joint_sweep`): that many uniformly sampled mappings (plus the
    search winners) crossed with the FULL hardware grid — ``(joint_genes
    + top_k) * |grid|`` designs through the gene pipeline — and merges
    its frontier/bests into the result."""
    t0 = time.perf_counter()
    dev = resolve_device(device)
    search_kwargs = dict(search_kwargs or {})
    block = search_kwargs.get("block", 1024)
    multicast = search_kwargs.get("multicast", True)
    spatial_reduction = search_kwargs.get("spatial_reduction", True)
    sr = search(op, objective=objective, budget=mapping_budget,
                space=space, num_pes=num_pes, noc_bw=noc_bw, seed=seed,
                cache_dir=cache_dir, cache_extra=cache_extra,
                ckpt_dir=ckpt_dir, device=dev, **search_kwargs)

    picked: list[tuple[str, tuple]] = []
    seen: set[tuple] = set()
    for entry in sr.top_k:
        df = point_dataflow(sr.space, entry["point"])
        if df.directives in seen:
            continue
        seen.add(df.directives)
        picked.append((df.name, entry["point"]))
        if len(picked) >= top_k:
            break

    cfg = cfg or DSEConfig()
    sweeps: list[tuple[str, DSEResult]] = []
    n_compiles = 0
    for label, point in picked:
        r, nc = _joint_sweep(op, sr.space, point, label, cfg, block=block,
                             multicast=multicast,
                             spatial_reduction=spatial_reduction,
                             device=dev)
        n_compiles += nc
        sweeps.append((label, r))
    for name in include_table3:
        sweeps.append((f"table3:{name}",
                       run_dse(op, table3_for_layer(name, op), cfg,
                               multicast=multicast,
                               spatial_reduction=spatial_reduction,
                               tile_tag=f"table3:{name}", device=dev)))

    joint: JointSweepResult | None = None
    if joint_genes > 0:
        rng = np.random.default_rng(seed + 1)
        gm = sample_genes(sr.space, rng, joint_genes)
        winners = genes_from_points([p for _, p in picked])
        gm = np.concatenate([winners, gm]) if len(winners) else gm
        jc = SweepCheckpoint(
            ckpt_dir, f"joint-{op.name}-{objective}-{joint_genes}-"
            f"{seed}-{cache_extra or 'local'}") if ckpt_dir else None
        joint = joint_sweep(op, sr.space, gm, cfg, objective=objective,
                            block=joint_block, multicast=multicast,
                            spatial_reduction=spatial_reduction,
                            ckpt=jc, device=dev)
        n_compiles += joint.n_compiles

    best: dict[str, dict[str, Any] | None] = {}
    for obj in ("throughput", "energy", "edp"):
        cands = [dict(r.best(obj), mapping=label)
                 for label, r in sweeps if r.n_valid]
        if joint is not None and joint.objective == obj and joint.top:
            cands.append(dict(joint.top[0],
                              mapping=f"joint:{joint.top[0]['point']}"))
        if not cands:
            best[obj] = None
            continue
        sign = (lambda p: -p["throughput"]) if obj == "throughput" else \
            (lambda p: p["energy_pj"] if obj == "energy" else p["edp"])
        best[obj] = min(cands, key=sign)

    pareto = merged_pareto(sweeps)
    if joint is not None and joint.pareto:
        pareto = pareto_front(
            pareto + [dict(p, mapping=f"joint:{p['point']}")
                      for p in joint.pareto])

    return CoDSEResult(
        search=sr,
        dse=sweeps,
        pareto=pareto,
        best=best,
        n_evaluated=sr.n_evaluated + sum(r.n_evaluated for _, r in sweeps)
        + (joint.n_designs if joint else 0),
        elapsed_s=time.perf_counter() - t0,
        n_compiles=sr.n_compiles + n_compiles,
        joint=joint)
