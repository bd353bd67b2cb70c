"""Graph audit of every universal evaluator family the engine builds (the
port's counterpart of ``repro.analysis.jaxpr_audit``, with codes of its
own).

The DSE side runs on a handful of "universal" evaluators (one per
(op-class, level-count) family — ``mapspace.universal``, the netspace
shape-as-operand variant, the co-DSE hardware tail).  The port has no
trace-only mode and compiles nothing, so each case runs its evaluator
once, eagerly, at 256 rows, under a recorder of aten ops (a
``TorchDispatchMode``), and the audit asserts on what it recorded:

``TORCH-F64``
    no float64 or complex128 tensor appears (the evaluators are float32
    end to end).  int64 is not a finding: it is torch's index type (the
    outputs of ``sort``, ``argsort``, ``topk``, ``cummax``) and the type
    torch's rules give the ``sum`` of a bool mask, which is what
    ``n_valid`` is — one count of at most a block's rows a chunk, read by
    the host after the chunk (``mapspace.universal.evaluate_genes``), where
    the reference's x64-off ``jnp.sum`` gives int32.  An explicit widening
    to int64 is still caught, by ``TORCH-WIDEN``;
``TORCH-WIDEN``
    no explicit conversion (``aten.to``/``aten._to_copy``) widens within
    a kind (float32 -> float64, int32 -> int64);
``TORCH-SYNC``
    no op inside the chunk needs the host to read device data
    (``_local_scalar_dense``: ``.item()``, ``float()``, ``bool()`` of a
    tensor; ``nonzero``, boolean-mask indexing and other data-dependent
    shapes; a copy to the CPU).  On the card the audit also runs the
    chunk under ``torch.cuda.set_sync_debug_mode("warn")``, and every
    synchronisation it flags that copies no host-made tensor is a finding
    too (a copy counts at the tensor's site, also where an op such as
    ``where`` moves a 0-d CPU tensor to the device itself);
``TORCH-H2D``
    no tensor is made from host data inside the chunk (``aten.lift_fresh``
    and kin: ``torch.tensor(v, device=...)``), since on the card each is
    a pageable host-to-device copy a call.  The site is the innermost
    frame of the code under audit (``core/vectorized.py::_reduce_tail``),
    one finding a site with the count in its message and in the report;
    it is detected by op, so the CPU and the card give the same findings
    and one waiver serves both;
``TORCH-UNUSED``
    every operand is read by some op — an operand no op reads means a
    value that should be an operand is baked in (the reference's
    ``JAX-CONSTFOLD``);
``TORCH-SHRINK``
    the fused evaluate-and-reduce tail shrinks: output bytes stay under
    half the operand bytes, so chunk memory stays O(block) (the
    reference's ``JAX-DONATION``);
``TORCH-OPBUDGET``
    aten ops per family stay under a checked-in budget (``OP_BUDGET``);
``TORCH-TRACE``
    the family runs at all (an error is itself a finding, not a crash).

The corpus is the reference's: a small conv2d and a gemm, 1-level and
2-level specs, in plain / reduced / co-DSE / netspace (ext-operand)
variants, at 256 rows.  It runs at one device: the port's evaluator
leaves device sharding to its caller (``core.vectorized``'s
``universal_reduced_evaluator``), where the reference traces a pmap per
device count.  On CUDA each case's report also carries what the card
did in one chunk: the kernels and host-to-device copies that
``torch.profiler`` counts, the synchronisations that sync debug mode
flags (by site), and the chunk's wall milliseconds.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import os
import sys
import time
import warnings
from typing import Any, Callable, Mapping

import numpy as np
import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from ..devices import resolve_device
from .findings import Finding

# aten ops per audit family, measured over every variant in the corpus
# (max: conv:L1 4488, conv:L2 15266, gemm:L1 1314, gemm:L2 2955, the
# netspace variant each time) with ~50% headroom.  A budget miss means an
# engine change materially grew the work of a chunk — raise the budget
# consciously, in review.
OP_BUDGET = {
    "audit-conv:L1": 6700,
    "audit-conv:L2": 22900,
    "audit-gemm:L1": 2000,
    "audit-gemm:L2": 4400,
}
# Fallback for families outside the checked-in corpus (custom audits).
_DEFAULT_BUDGET = {"L1": 6700, "L2": 22900}

N_ROWS = 256

aten = torch.ops.aten
_LIFT = frozenset({aten.lift_fresh, aten.lift_fresh_copy, aten.lift})
_HOST_READS = frozenset({
    aten._local_scalar_dense, aten.nonzero, aten.masked_select,
    aten.unique_consecutive, aten._unique, aten._unique2, aten.unique_dim,
    aten.equal,
})
_CONVERT = frozenset({aten.to, aten._to_copy})
_BOOL_INDEXED = frozenset({aten.index, aten.index_put, aten.index_put_,
                           aten._index_put_impl_})
_WIDE = frozenset({torch.float64, torch.complex128})
_SYNC_WARNING = "synchronizing CUDA operation"

_PORT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SKIP = (os.path.dirname(os.path.abspath(torch.__file__)) + os.sep,
         os.path.abspath(__file__), os.path.abspath(warnings.__file__))


def _budget_for(family: str) -> int:
    return OP_BUDGET.get(
        family, _DEFAULT_BUDGET["L2" if family.endswith(":L2") else "L1"])


@dataclasses.dataclass(frozen=True)
class FamilyCase:
    """One audited evaluator: the callable, its operand dict (numpy,
    moved to the audit's device before the chunk runs) and its kind."""
    name: str                     # e.g. "audit-conv:L2/codse"
    family: str                   # family label, e.g. "audit-conv:L2"
    fn: Callable
    ops: dict[str, np.ndarray]
    kind: str                     # plain | reduced | codse | netspace
    # operands the unused-operand check tolerates: a one-hot over ONE
    # cluster candidate carries no information, so the evaluator
    # rightly never reads it — that is not a baked-in value
    allow_unused: tuple[str, ...] = ()


# ----------------------------------------------------------------------
# Corpus: the reference's families, at one device
# ----------------------------------------------------------------------

def _audit_ops():
    from ..core.tensor_analysis import conv2d, gemm
    return [conv2d("audit-conv", k=8, c=6, y=10, x=10, r=3, s=3),
            gemm("audit-gemm", m=32, n=64, k=64)]


def _points(space, *, cluster: bool, n: int) -> list[tuple]:
    """n valid points of one level-count family (minimum tiles)."""
    cs = [i for i, c in enumerate(space.cluster_options)
          if (c is not None) == cluster]
    base = (0,) * len(space.axes)
    pts = [(s, p, c) + base
           for s in range(len(space.spatial_choices))
           for p in range(len(space.perms))
           for c in cs]
    return (pts * (n // len(pts) + 1))[:n]


def _with_live(ops: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    n = len(ops["pes"])
    return dict(ops, live=np.ones((n,), np.float32))


def _ext_ops(op, spec, ops: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Extend base operands with the netspace shape-as-operand columns."""
    n = len(ops["pes"])
    ext = np.asarray([op.dims[d] for d in spec.dim_names], np.float32)
    out = dict(ops, ext=np.tile(ext, (n, 1)))
    if spec.cluster:
        out["cin_size"] = np.tile(np.asarray(
            [c[1] for c in spec.cluster], np.float32), (n, 1))
        out["cin_off"] = np.tile(np.asarray(
            [c[2] for c in spec.cluster], np.float32), (n, 1))
    return out


def build_cases() -> list[FamilyCase]:
    """The audit corpus: every (op, level-count) family in its plain,
    reduced, co-DSE and netspace variants."""
    from ..core.dse import DSEConfig
    from ..core.vectorized import (HWTail, ReduceSpec, universal_evaluator,
                                   universal_reduced_evaluator)
    from ..mapspace.space import build_space
    from ..mapspace.universal import encode_points, universal_specs

    cfg = DSEConfig()
    reduce = ReduceSpec(objective="edp", k=4)
    codse = dataclasses.replace(reduce, hw=HWTail(
        area_power=cfg.area_power, area_budget_mm2=cfg.area_budget_mm2,
        power_budget_mw=cfg.power_budget_mw))
    net_reduce = ReduceSpec(objective="runtime", k=1, pareto=False,
                            cols=("runtime", "energy_pj", "l1_kb", "l2_kb"))
    cases: list[FamilyCase] = []
    for op in _audit_ops():
        space = build_space(op)
        for spec in universal_specs(op, space):
            if spec is None:
                continue
            fam = f"{op.name}:L{2 if spec.cluster else 1}"
            pts = _points(space, cluster=bool(spec.cluster), n=N_ROWS)
            base = encode_points(op, space, pts, spec,
                                 num_pes=64, noc_bw=32.0)
            nspec = dataclasses.replace(spec, ext_operand=True)
            tolerate = ("csel",) if len(spec.cluster) == 1 else ()
            cases.append(FamilyCase(
                name=f"{fam}/plain", family=fam, kind="plain",
                fn=universal_evaluator(op, spec), ops=base,
                allow_unused=tolerate))
            for kind, rspec in (("reduced", reduce), ("codse", codse)):
                cases.append(FamilyCase(
                    name=f"{fam}/{kind}", family=fam, kind=kind,
                    fn=universal_reduced_evaluator(op, spec, rspec),
                    ops=_with_live(base), allow_unused=tolerate))
            cases.append(FamilyCase(
                name=f"{fam}/netspace", family=fam, kind="netspace",
                fn=universal_reduced_evaluator(op, nspec, net_reduce),
                ops=_with_live(_ext_ops(op, nspec, base)),
                allow_unused=tolerate))
    return cases


# ----------------------------------------------------------------------
# The recorder
# ----------------------------------------------------------------------

def _site(frame) -> tuple[str, str]:
    """(site, file:line) of the innermost frame of the code under audit:
    the first frame outside torch, this module and ``warnings``, named
    ``module.py::function`` relative to the port's root (by file name
    outside it)."""
    while frame is not None:
        path = os.path.abspath(frame.f_code.co_filename)
        if not path.startswith(_SKIP):
            rel = (os.path.relpath(path, _PORT).replace(os.sep, "/")
                   if path.startswith(_PORT + os.sep)
                   else os.path.basename(path))
            fn = frame.f_code.co_qualname.replace(".<locals>", "")
            return f"{rel}::{fn}", f"{rel}:{frame.f_lineno}"
        frame = frame.f_back
    return "<unknown>", ""


def _kind(dt: torch.dtype) -> str:
    if dt.is_complex:
        return "c"
    if dt.is_floating_point:
        return "f"
    if dt == torch.bool:
        return "b"
    return "i" if dt.is_signed else "u"


class _Recorder(TorchDispatchMode):
    """Counts every aten op of a chunk and notes what the audit checks:
    the operands read, wide dtypes, widening conversions, host reads and
    host-made tensors (by site)."""

    @classmethod
    def _should_skip_dynamo(cls) -> bool:
        # the audit never runs under torch.compile: no dynamo-disabling
        # wrapper around __torch_dispatch__ (it imports torch._dynamo,
        # seconds, and wraps every op)
        return False

    def __init__(self, operands: Mapping[str, torch.Tensor]) -> None:
        super().__init__()
        self.n_ops = 0
        self._operand = {id(t): k for k, t in operands.items()}
        self.read: set[str] = set()
        self.wide: set[str] = set()
        self.widen: set[str] = set()
        self.host_made: collections.Counter = collections.Counter()
        self.host_reads: collections.Counter = collections.Counter()
        self.where: dict[str, str] = {}
        # host-made tensors by id (kept alive, so no id is reused), and the
        # sites of ops that take one on the CPU into a device op (``where``
        # moves a 0-d CPU operand to the device: a copy of its own)
        self._host: dict[int, tuple[torch.Tensor, str]] = {}
        self.carried: dict[str, set[str]] = {}

    def _at(self, what: collections.Counter, label: str = "") -> str:
        site, where = _site(sys._getframe())
        what[(site, label) if label else site] += 1
        self.where.setdefault(site, where)
        return site

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.n_ops += 1
        packet = func.overloadpacket
        ins = [a for a in pytree.tree_leaves((args, kwargs))
               if isinstance(a, torch.Tensor)]
        outs = [o for o in pytree.tree_leaves(out)
                if isinstance(o, torch.Tensor)]
        for t in ins:
            key = self._operand.get(id(t))
            if key is not None:
                self.read.add(key)
        for t in outs:
            if t.dtype in _WIDE:
                self.wide.add(f"{func.__name__} -> "
                              f"{str(t.dtype).removeprefix('torch.')}")
        carried = {self._host[id(t)][1] for t in ins
                   if id(t) in self._host and t.device.type == "cpu"}
        if carried and any(o.device.type != "cpu" for o in outs):
            site, _ = _site(sys._getframe())
            self.carried.setdefault(site, set()).update(carried)
        if packet in _LIFT:
            site = self._at(self.host_made)
            for t in outs:
                self._host[id(t)] = (t, site)
        elif packet in _HOST_READS:
            self._at(self.host_reads, func.__name__)
        elif packet in _BOOL_INDEXED and any(
                isinstance(i, torch.Tensor) and i.dtype == torch.bool
                for i in pytree.tree_leaves(args[1:2])):
            self._at(self.host_reads, f"{func.__name__} by a bool mask")
        elif packet in _CONVERT and ins and outs:
            src, dst = ins[0], outs[0]
            if src.device.type != "cpu" and dst.device.type == "cpu":
                self._at(self.host_reads, f"{func.__name__} to the CPU")
            if _kind(src.dtype) == _kind(dst.dtype) \
                    and dst.dtype.itemsize > src.dtype.itemsize:
                self.widen.add(
                    f"{str(src.dtype).removeprefix('torch.')} -> "
                    f"{str(dst.dtype).removeprefix('torch.')}")
        elif packet is aten.copy_ and len(ins) >= 2 \
                and ins[0].device.type == "cpu" \
                and ins[1].device.type != "cpu":
            self._at(self.host_reads, "copy_ to the CPU")
        return out


# ----------------------------------------------------------------------
# The card: kernels, copies and flagged synchronisations of one chunk
# ----------------------------------------------------------------------

def _card_counts(fn: Callable, ops: Mapping[str, torch.Tensor]
                 ) -> dict[str, Any]:
    """What one chunk costs on the card: wall ms (host clock to a
    synchronize, after a warm-up chunk), then the kernels and
    host-to-device copies ``torch.profiler`` counts in a chunk, the larger
    count of two profiled chunks (a record the profiler drops only ever
    lowers a count, and single chunks have read short on the card)."""
    from torch.profiler import ProfilerActivity, profile
    fn(ops)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn(ops)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = h2d = 0
    for _ in range(2):
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message=".*clears events")
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fn(ops)
                torch.cuda.synchronize()
        # the raw device events: ``prof.events()`` would build the
        # profiler's event tree first, seconds a chunk of ~10^4 kernels
        names = [e.name() for e in prof.profiler.kineto_results.events()
                 if e.device_type() == torch.autograd.DeviceType.CUDA]
        copies = [n for n in names if "Memcpy" in n or "Memset" in n]
        kernels = max(kernels, len(names) - len(copies))
        h2d = max(h2d, sum("HtoD" in n for n in copies))
    return {"wall_ms": wall_ms, "kernels": kernels, "h2d_copies": h2d}


@contextlib.contextmanager
def _flagged_syncs():
    """Count, by the site of the code under audit, the synchronisations
    that ``torch.cuda.set_sync_debug_mode("warn")`` flags while the block
    runs (a prototype in torch: it does not see every synchronising
    operation); the mode is reset on the way out."""
    flagged: collections.Counter = collections.Counter()
    shown = warnings.showwarning

    def show(message, category, filename, lineno, file=None, line=None):
        if _SYNC_WARNING in str(message):
            flagged[_site(sys._getframe())[0]] += 1
        else:
            shown(message, category, filename, lineno, file, line)

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.filterwarnings("ignore", message=".*prototype feature")
        warnings.showwarning = show
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield flagged
        finally:
            torch.cuda.set_sync_debug_mode(prev)


# ----------------------------------------------------------------------
# One case
# ----------------------------------------------------------------------

def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size()
               for t in pytree.tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def audit_case(case: FamilyCase, device: str | torch.device | None = None
               ) -> tuple[list[Finding], dict[str, Any]]:
    """Findings + the record of one evaluator family variant on
    ``device`` (``cuda`` unless the caller asks for another): aten ops,
    host-made tensors by site, the budget, and on CUDA what the card did
    in one chunk (kernels, host-to-device copies, flagged synchronisations
    by the site of the tensor they copy, wall ms)."""
    dev = resolve_device(device)
    site = f"graph::{case.name}"
    budget = _budget_for(case.family)
    record: dict[str, Any] = {"family": case.family, "kind": case.kind,
                              "aten_ops": 0, "host_made": {},
                              "budget": budget, "device": dev.type}
    findings: list[Finding] = []

    def f(code: str, msg: str, at: str = site, where: str = "") -> None:
        findings.append(Finding(code=code, site=at, analyzer="graph",
                                message=msg, where=where))

    flagged: collections.Counter = collections.Counter()
    try:
        ops = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
               for k, v in case.ops.items()}
        rec = _Recorder(ops)
        if dev.type == "cuda":
            record.update(_card_counts(case.fn, ops))
            with _flagged_syncs() as flagged, rec:
                out = case.fn(ops)
            torch.cuda.synchronize()
        else:
            with rec:
                out = case.fn(ops)
    except Exception as e:                        # noqa: BLE001
        f("TORCH-TRACE", f"{type(e).__name__}: {e}")
        return findings, record

    record["aten_ops"] = rec.n_ops
    record["host_made"] = dict(rec.host_made)
    for k, t in ops.items():
        if t.dtype in _WIDE:
            rec.wide.add(f"operand {k!r} is "
                         f"{str(t.dtype).removeprefix('torch.')}")
    for what in sorted(rec.wide):
        f("TORCH-F64", f"64-bit value in the chunk: {what}")
    for what in sorted(rec.widen):
        f("TORCH-WIDEN", f"explicit conversion widens: {what}")
    for s, n in sorted(rec.host_made.items()):
        f("TORCH-H2D", f"{n} tensor(s) made from host data inside the "
          f"chunk ({case.name}): one pageable host-to-device copy each "
          f"on the card", at=s, where=rec.where.get(s, ""))
    reads: dict[str, list[str]] = {}
    for (s, op), n in sorted(rec.host_reads.items()):
        reads.setdefault(s, []).append(f"{n} x {op}")
    for s, what in reads.items():
        f("TORCH-SYNC", f"the host reads device data inside the chunk "
          f"({case.name}): {', '.join(what)}", at=s,
          where=rec.where.get(s, ""))
    if dev.type == "cuda":
        # a flagged sync where an op carried a host-made tensor to the
        # device is that tensor's copy: it counts at the tensor's site
        syncs: collections.Counter = collections.Counter()
        for s, n in flagged.items():
            syncs[s if s in rec.host_made
                  else min(rec.carried.get(s, {s}))] += n
        record["syncs"] = dict(syncs)
        record["sync_frames"] = dict(flagged)
        for s, n in sorted(syncs.items()):
            if s not in rec.host_made and s not in reads:
                f("TORCH-SYNC", f"{n} synchronisation(s) flagged by sync "
                  f"debug mode inside the chunk ({case.name})", at=s,
                  where=rec.where.get(s, ""))
    for key in sorted(set(ops) - rec.read - set(case.allow_unused)):
        f("TORCH-UNUSED", f"operand {key!r} is read by no op — its value "
          f"must be baked in, not an operand")
    if case.kind in ("reduced", "codse", "netspace"):
        in_b, out_b = _nbytes(ops), _nbytes(out)
        if out_b * 2 > in_b:
            f("TORCH-SHRINK", f"reduce tail returns {out_b} B for {in_b} B "
              f"of operands (> 1/2): chunk memory is no longer O(block)")
    if rec.n_ops > budget:
        f("TORCH-OPBUDGET", f"{rec.n_ops} aten ops exceeds the "
          f"{case.family.split(':')[-1]} budget of {budget}")
    return findings, record


# ----------------------------------------------------------------------
# Entry point
# ----------------------------------------------------------------------

def _merge_by_site(findings: list[Finding], record: dict[str, dict]
                   ) -> list[Finding]:
    """One ``TORCH-H2D`` finding a site over all cases, with the total
    and the largest case in its message."""
    out = [f for f in findings if f.code != "TORCH-H2D"]
    by_site: dict[str, list[tuple[int, str]]] = {}
    where: dict[str, str] = {}
    for name, rec in record.items():
        for s, n in rec["host_made"].items():
            by_site.setdefault(s, []).append((n, name))
    for f in findings:
        if f.code == "TORCH-H2D":
            where.setdefault(f.site, f.where)
    for s, counts in sorted(by_site.items()):
        n_max, worst = max(counts)
        out.append(Finding(
            code="TORCH-H2D", site=s, analyzer="graph", where=where[s],
            message=f"{sum(n for n, _ in counts)} tensors made from host "
                    f"data inside the chunks of {len(counts)} case(s), "
                    f"{n_max} in {worst}: one pageable host-to-device "
                    f"copy each on the card"))
    return out


def audit(device: str | torch.device | None = None
          ) -> tuple[list[Finding], dict[str, Any]]:
    """Run the full audit on ``device`` (``cuda`` unless the caller asks
    for another; raises without a GPU).  Returns ``(findings, report)``:
    the report carries, per case, the aten ops, host-made tensors by
    site, the budget and the device, and on CUDA the kernels, host-to-
    device copies, flagged synchronisations and wall ms of one chunk."""
    dev = resolve_device(device)
    findings: list[Finding] = []
    cases: dict[str, dict] = {}
    for case in build_cases():
        fs, rec = audit_case(case, dev)
        findings += fs
        cases[case.name] = rec
    report = {
        "cases": cases,
        "op_budget": dict(OP_BUDGET),
        "device": dev.type,
        "device_name": (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else "cpu"),
        "n_cases": len(cases),
    }
    return _merge_by_site(findings, cases), report
