"""Batched mapping evaluation — the tuple-point path that the gene
pipeline is held against (``search(pipeline="legacy")``).

Default engine: the **universal** structure-as-operand evaluator
(``mapspace.universal``) — one evaluator per (op, level-count) whose
operands encode the entire mapping (tile sizes, permutation rank, spatial
one-hot, cluster option, hardware point).

The **grouped** engine (one tile evaluator per structure group, tile
sizes as the only operands) is kept behind ``engine="grouped"`` as a
test oracle only: the universal engine is held against it.  The
reference also degrades a failing gene pipeline to it; that path comes
with the port's front door, and nothing in the port selects the grouped
engine yet.  Batches are
padded to a fixed block, as the reference pads to one executable shape;
timing separates the first (warm-up) pass at each (block, structure) shape
from the steady-state evaluation the mappings/s rate is quoted on.  Every
entry point runs on ``device`` (``cuda`` unless the caller asks for
another); where the reference blocks on an executable's result, the port
copies the result to the host or synchronizes the device.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Sequence

import numpy as np
import torch

from .. import obs
from ..devices import resolve_device
from ..core.tensor_analysis import LayerOp
from ..core.vectorized import FEATURES, batched_tile_evaluator
from .space import GroupKey, MapSpace, Point, group_template, point_operands
from .universal import _on, _sync, evaluate_points_universal

# Column indices into the feature matrix, re-exported for consumers.
FEATURE_INDEX = {name: i for i, name in enumerate(FEATURES)}

# Grouped-engine evaluators already warmed at a given block shape this
# process, keyed by the deterministic (op, template, hardware, block,
# device type) tuple.
_WARMED: set[tuple] = set()


def _warm_key(op: LayerOp, template_name: str, var_slots, num_pes,
              noc_bw, multicast, spatial_reduction, block: int,
              device: torch.device) -> tuple:
    return (op.name, tuple(sorted(op.dims.items())), op.op_type,
            template_name, tuple(var_slots), int(num_pes), float(noc_bw),
            bool(multicast), bool(spatial_reduction), block, device.type)


@dataclasses.dataclass
class EvalStats:
    """Bookkeeping for one evaluate_points call.

    ``mappings_per_s`` is THE steady-state rate definition shared by every
    consumer (``SearchResult`` delegates here): rows actually evaluated in
    steady-timed calls (padding rows excluded, first-call compile re-runs
    excluded) divided by the steady evaluation time."""
    n_points: int = 0
    n_groups: int = 0
    n_steady: int = 0        # rows evaluated in steady-timed calls
    n_compiles: int = 0      # first (warm-up) passes
    compile_s: float = 0.0   # first pass per (evaluator, block shape)
    eval_s: float = 0.0      # steady-state batched evaluation time
    encode_s: float = 0.0    # host operand-encode time (gene pipeline)

    @property
    def mappings_per_s(self) -> float:
        """Steady-state rate; 0.0 when every call was a first (warm-up)
        pass (no steady sample exists)."""
        if not self.n_steady:
            return 0.0
        return self.n_steady / max(self.eval_s, 1e-9)

    def merge(self, other: "EvalStats") -> None:
        self.n_points += other.n_points
        self.n_groups += other.n_groups
        self.n_steady += other.n_steady
        self.n_compiles += other.n_compiles
        self.compile_s += other.compile_s
        self.eval_s += other.eval_s
        self.encode_s += other.encode_s


def evaluate_points(op: LayerOp, space: MapSpace, points: Sequence[Point],
                    *, num_pes: int, noc_bw: float, block: int = 1024,
                    multicast: bool = True, spatial_reduction: bool = True,
                    engine: str = "universal",
                    device: str | torch.device | None = None
                    ) -> tuple[np.ndarray, EvalStats]:
    """Evaluate mappings at a fixed hardware point on ``device``.

    Returns ``(features[n, F], stats)`` with rows aligned to ``points``
    order.  Points may mix structure groups freely: the universal engine
    needs at most two evaluators regardless; the grouped engine regroups
    internally and runs one evaluator per group."""
    dev = resolve_device(device)
    if engine == "universal":
        feats, run = evaluate_points_universal(
            op, space, points, num_pes=num_pes, noc_bw=noc_bw,
            block=block, multicast=multicast,
            spatial_reduction=spatial_reduction, device=dev)
        obs.metrics().inc("mappings.evaluated", len(points))
        groups = {space.group_key(p) for p in points}
        return feats, EvalStats(
            n_points=len(points), n_groups=len(groups),
            n_steady=len(points), n_compiles=run.n_compiles,
            compile_s=run.compile_s, eval_s=run.eval_s)
    if engine != "grouped":
        raise ValueError(f"unknown engine {engine!r}")

    groups: dict[GroupKey, list[int]] = {}
    for i, pt in enumerate(points):
        groups.setdefault(space.group_key(pt), []).append(i)

    feats = np.empty((len(points), len(FEATURES)), np.float32)
    stats = EvalStats(n_points=len(points), n_groups=len(groups))
    for key, idxs in groups.items():
        template, var_slots = group_template(space, key)
        f = batched_tile_evaluator(
            op, template, var_slots, num_pes=num_pes, noc_bw=noc_bw,
            multicast=multicast, spatial_reduction=spatial_reduction,
            device=dev)
        sizes, offsets = point_operands(space, [points[i] for i in idxs])
        for lo in range(0, len(idxs), block):
            hi = min(lo + block, len(idxs))
            pad = block - (hi - lo)
            s = np.concatenate([sizes[lo:hi],
                                np.repeat(sizes[lo:lo + 1], pad, 0)]) \
                if pad else sizes[lo:hi]
            o = np.concatenate([offsets[lo:hi],
                                np.repeat(offsets[lo:lo + 1], pad, 0)]) \
                if pad else offsets[lo:hi]
            warm_key = _warm_key(op, template.name, var_slots, num_pes,
                                 noc_bw, multicast, spatial_reduction,
                                 block, dev)
            sj = torch.from_numpy(np.ascontiguousarray(s)).to(dev)
            oj = torch.from_numpy(np.ascontiguousarray(o)).to(dev)
            if warm_key not in _WARMED:
                # first pass at this shape: the warm-up — re-run timed so
                # every group contributes a steady-rate sample
                with obs.span("compile", engine="grouped", op=op.name,
                              group=template.name), _on(dev):
                    t0 = time.perf_counter()
                    f(sj, oj).cpu()
                    dt = time.perf_counter() - t0
                stats.compile_s += dt
                stats.n_compiles += 1
                _WARMED.add(warm_key)
                obs.metrics().inc("grouped.compiles")
                obs.metrics().inc("grouped.compile_s", dt)
            with obs.span("device-pass", engine="grouped", op=op.name,
                          rows=hi - lo), _on(dev):
                t0 = time.perf_counter()
                out = f(sj, oj).cpu().numpy()
                dt = time.perf_counter() - t0
            stats.eval_s += dt
            stats.n_steady += hi - lo
            feats[idxs[lo:hi]] = out[:hi - lo]
    obs.metrics().inc("mappings.evaluated", len(points))
    return feats, stats


def measure_rate(op: LayerOp, space: MapSpace, *, num_pes: int,
                 noc_bw: float, block: int = 4096, seconds: float = 2.0,
                 seed: int = 0, group: GroupKey | None = None,
                 multicast: bool = True, spatial_reduction: bool = True,
                 device: str | torch.device | None = None) -> float:
    """Steady-state batched evaluation rate (mappings/s) of the universal
    engine on ``device`` — the number comparable to the paper's 0.17M
    designs/s DSE rate.  It times mixed-structure rows sampled uniformly
    over the whole space (or one ``group``).  The reference's grouped
    branch is left out with the grouped engine's other uses."""
    from .universal import encode_points, mark_warmed, universal_specs
    from ..core.vectorized import universal_evaluator
    rng = np.random.default_rng(seed)
    dev = resolve_device(device)
    keys = space.group_keys() if group is None else [group]
    pts = []
    for _ in range(block):
        key = keys[int(rng.integers(len(keys)))]
        tiles = tuple(int(rng.integers(ax.n)) for ax in space.axes)
        pts.append(tuple(key) + tiles)
    spec1, spec2 = universal_specs(op, space)
    batches = []
    for spec, sub in (
            (spec1, [p for p in pts
                     if space.cluster_options[p[2]] is None]),
            (spec2, [p for p in pts
                     if space.cluster_options[p[2]] is not None])):
        if not sub:
            continue
        ops = encode_points(op, space, sub, spec,
                            num_pes=num_pes, noc_bw=noc_bw)
        f = universal_evaluator(op, spec, multicast=multicast,
                                spatial_reduction=spatial_reduction)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in ops.items()}
        # timed batches have their own shape: count the warm-up so the
        # process-wide counter sees it
        mark_warmed(op, spec, multicast, spatial_reduction, len(sub), dev)
        with _on(dev):
            f(batch)                    # warm-up
        _sync([dev])
        batches.append((f, batch))
    n = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for f, batch in batches:
            with _on(dev):
                f(batch)
            _sync([dev])
        n += block
    return n / (time.perf_counter() - t0)
