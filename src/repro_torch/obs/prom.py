"""Prometheus text exposition of a ``Metrics.snapshot()`` (the port's copy
of ``repro.obs.prom``: the same text for the same snapshot).

Renders the snapshot dict (the same one ``/metricsz`` serves as JSON)
in the Prometheus text format, version 0.0.4, with OpenMetrics-style
exemplars on bucketed-histogram lines:

    serve_latency_s_bucket{kind="layer",le="0.25"} 17 # {request_id="ab12"} 0.093

Mapping:

  * counters  -> ``# TYPE <name> counter``  (dots become underscores;
    the ``name[k=v,...]`` label key encoding round-trips into real
    ``{k="v"}`` label sets)
  * gauges    -> ``# TYPE <name> gauge``
  * streaming histograms (count/total/min/max) -> ``# TYPE <name>
    summary`` with ``_sum``/``_count``
  * bucketed histograms -> ``# TYPE <name> histogram`` with cumulative
    ``_bucket{le="..."}`` rows, an explicit ``le="+Inf"``, and
    ``_sum``/``_count``

Pure function over the snapshot — no locks, no registry access — so it
renders identically for a live server and a saved snapshot file.
"""
from __future__ import annotations

import re
from typing import Any

__all__ = ["CONTENT_TYPE", "prometheus_text"]

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

_NAME_BAD = re.compile(r"[^a-zA-Z0-9_:]")


def _san(name: str) -> str:
    n = _NAME_BAD.sub("_", name)
    return ("_" + n) if n[:1].isdigit() else (n or "_")


def _parse_key(key: str) -> tuple[str, dict[str, str]]:
    """Invert ``metrics._key``: ``'a.b[k=v,k2=v2]'`` -> name + labels."""
    if key.endswith("]") and "[" in key:
        name, _, inner = key[:-1].partition("[")
        labels = {}
        for part in inner.split(","):
            k, _, v = part.partition("=")
            labels[k] = v
        return name, labels
    return key, {}


def _esc(v: Any) -> str:
    return (str(v).replace("\\", r"\\").replace('"', r'\"')
            .replace("\n", r"\n"))


def _labels(labels: dict[str, Any]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{_san(str(k))}="{_esc(v)}"'
                     for k, v in labels.items())
    return "{" + inner + "}"


def _num(v: float) -> str:
    f = float(v)
    return str(int(f)) if f.is_integer() else repr(f)


class _Writer:
    def __init__(self) -> None:
        self.lines: list[str] = []
        self._typed: set[str] = set()

    def type_line(self, family: str, kind: str) -> None:
        if family not in self._typed:
            self._typed.add(family)
            self.lines.append(f"# TYPE {family} {kind}")

    def sample(self, name: str, labels: dict[str, Any], value: float,
               exemplar: dict[str, Any] | None = None) -> None:
        line = f"{name}{_labels(labels)} {_num(value)}"
        if exemplar:
            line += (f' # {{request_id="{_esc(exemplar["request_id"])}"}}'
                     f' {_num(exemplar["value"])}')
        self.lines.append(line)


def prometheus_text(snapshot: dict[str, Any]) -> str:
    """Render a ``Metrics.snapshot()`` (or a ``Session.metrics()`` dict,
    whose extra non-metric blocks are ignored) as Prometheus text."""
    w = _Writer()
    for key, value in snapshot.get("counters", {}).items():
        name, labels = _parse_key(key)
        fam = _san(name)
        w.type_line(fam, "counter")
        w.sample(fam, labels, value)
    for key, value in snapshot.get("gauges", {}).items():
        name, labels = _parse_key(key)
        fam = _san(name)
        w.type_line(fam, "gauge")
        w.sample(fam, labels, value)
    for key, h in snapshot.get("histograms", {}).items():
        name, labels = _parse_key(key)
        fam = _san(name)
        w.type_line(fam, "summary")
        w.sample(fam + "_sum", labels, h["total"])
        w.sample(fam + "_count", labels, h["count"])
    for key, h in snapshot.get("bucket_histograms", {}).items():
        name, labels = _parse_key(key)
        fam = _san(name)
        w.type_line(fam, "histogram")
        exemplars = h.get("exemplars", {})
        for le, cum in h["buckets"]:
            le_s = le if isinstance(le, str) else _num(le)
            w.sample(fam + "_bucket", {**labels, "le": le_s}, cum,
                     exemplars.get(str(le)))
        w.sample(fam + "_sum", labels, h["total"])
        w.sample(fam + "_count", labels, h["count"])
    return "\n".join(w.lines) + "\n"
