"""Carry state from the JAX package into the port.

On the MAESTRO side the two packages share the layers, the dataflows and
the kernel's static tables.  Each is handed over
as plain Python values the reference can export without either package
importing the other:

* a layer as ``dataclasses.asdict(op)`` of a ``repro`` ``LayerOp``; it is
  rebuilt with the port's constructor for its ``op_type`` (from its dims and
  conv stride) and checked field by field against what was handed over;
* a dataflow as its name plus directive tuples ``("SpatialMap" |
  "TemporalMap", size, offset, dim)`` or ``("Cluster", size)``, where a size
  is an int or ``("Sz", dim)``;
* ``dataclasses.asdict`` of a ``repro`` ``EvalTables``.

Numpy scalars in the plain values are turned into Python numbers, so the
port's hybrid backend sees static values exactly where the reference does.

The LLM side shares weights: a model's parameters are handed over as a
nested dict of numpy arrays with the JAX names and layout
(``params_from_jax``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterable, Mapping

import numpy as np
import torch

from .core import tensor_analysis as ta
from .core.directives import Cluster, Dataflow, SpatialMap, Sz, TemporalMap
from .core.tensor_analysis import LayerOp
from .devices import resolve_device
from .kernels.maestro_eval.tables import CaseRow, EvalTables


def _py(v):
    """Numpy scalars -> Python scalars; containers recursively."""
    if hasattr(v, "item") and not isinstance(v, (int, float, bool, str)):
        return v.item()
    if isinstance(v, dict):
        return {k: _py(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(_py(x) for x in v)
    return v


def _stride(plain: Mapping[str, Any]) -> int:
    """Conv stride of a layer: the stride of its output's window entries
    (1 when it has none)."""
    for e in plain["output"]["entries"]:
        if "stride" in e:
            return e["stride"]
    return 1


def _rebuild(plain: Mapping[str, Any]) -> LayerOp:
    name, op_type, d = plain["name"], plain["op_type"], plain["dims"]
    stride = _stride(plain)
    if op_type == "CONV2D":
        return ta.conv2d(name, n=d["N"], k=d["K"], c=d["C"], y=d["Y"],
                         x=d["X"], r=d["R"], s=d["S"], stride=stride)
    if op_type in ("DWCONV", "POOL"):
        return ta.dwconv2d(name, n=d["N"], c=d["C"], y=d["Y"], x=d["X"],
                           r=d["R"], s=d["S"], stride=stride,
                           weightless=not plain["filter"]["has_data"],
                           op_type=op_type)
    if op_type == "FC":
        return ta.fc(name, n=d["N"], k=d["K"], c=d["C"])
    if op_type == "CONV1D":
        return ta.conv1d_outputs(name, x_out=d["X"], s=d["S"],
                                 stride=stride)
    if op_type == "CONV2D_OS":
        return ta.conv2d_outputs(name, n=d["N"], k=d["K"], c=d["C"],
                                 y_out=d["Y"], x_out=d["X"], r=d["R"],
                                 s=d["S"], stride=stride)
    raise ValueError(f"interop: unknown op_type {op_type!r}")


def layer_from_plain(plain: Mapping[str, Any]) -> LayerOp:
    """``dataclasses.asdict`` of a reference ``LayerOp`` -> the port's."""
    plain = _py(dict(plain))
    op = _rebuild(plain)
    if dataclasses.asdict(op) != plain:
        raise ValueError(f"interop: layer {plain['name']!r} does not "
                         "rebuild to the same structure")
    return op


def _size(v):
    if isinstance(v, (tuple, list)):
        tag, dim = v
        if tag != "Sz":
            raise ValueError(f"interop: unknown symbolic size {v!r}")
        return Sz(dim)
    return int(v)


def plain_dataflow(df) -> tuple[str, tuple[tuple, ...]]:
    """Export any ``Dataflow`` (the reference's or the port's: only its
    attributes are read) as (name, directive tuples)."""
    def size(v):
        return ("Sz", v.dim) if type(v).__name__ == "Sz" else int(v)

    out = []
    for d in df.directives:
        kind = type(d).__name__
        if kind == "Cluster":
            out.append((kind, size(d.size)))
        else:
            out.append((kind, size(d.size), size(d.offset), d.dim))
    return df.name, tuple(out)


def dataflow_from_plain(name: str, directives: Iterable[tuple]) -> Dataflow:
    """Directive tuples -> the port's ``Dataflow``."""
    out = []
    for d in directives:
        kind = d[0]
        if kind == "Cluster":
            out.append(Cluster(_size(d[1])))
        elif kind in ("SpatialMap", "TemporalMap"):
            cls = SpatialMap if kind == "SpatialMap" else TemporalMap
            out.append(cls(_size(d[1]), _size(d[2]), str(d[3])))
        else:
            raise ValueError(f"interop: unknown directive kind {kind!r}")
    return Dataflow(name, tuple(out))


def tables_from_plain(plain: Mapping[str, Any]) -> EvalTables:
    """``dataclasses.asdict`` of a reference ``EvalTables`` -> the port's."""
    plain = _py(dict(plain))
    cases = tuple(CaseRow(**c) for c in plain.pop("cases"))
    return EvalTables(cases=cases, **plain)


def _tensor(a: np.ndarray, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: same bits
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device)


def params_from_jax(tree: Mapping[str, Any],
                    device: str | torch.device | None = None) -> dict:
    """A nested dict of numpy arrays (``jax.tree.map(np.asarray, params)``
    of a JAX model's parameters) -> the port's tensors on ``device``, same
    names, shapes and dtypes."""
    dev = resolve_device(device)
    return {k: params_from_jax(v, dev) if isinstance(v, Mapping)
            else _tensor(v, dev) for k, v in tree.items()}
