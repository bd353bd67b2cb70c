"""The shared finding/waiver schema of the static analyzers (the port's
copy of ``repro.analysis.findings``).

Every analyzer (``concurrency``, ``speclint`` and ``graph_audit``, the
counterpart of the reference's jaxpr audit with codes of its own)
reports :class:`Finding` rows with a registered code;
``repro_torch.launch.lint`` consumes them uniformly.  Intentional
exceptions live in a checked-in ``waivers.toml`` next to this module —
each waiver names the (code, site) pair it excuses plus a one-line
justification, and a waiver that matches no finding FAILS the lint
(stale waivers rot into blind spots; the lint forces their removal the
moment the underlying code is fixed).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Iterable, Sequence

try:                                  # stdlib on 3.11+ (the CI floor)
    import tomllib
except ModuleNotFoundError:           # 3.10: the vendored shim
    import tomli as tomllib  # type: ignore[no-redef]

# ----------------------------------------------------------------------
# Finding codes — the registry the README documents
# ----------------------------------------------------------------------

CODES: dict[str, str] = {
    # graph audit of the universal evaluators (analysis/graph_audit.py)
    "TORCH-TRACE": "evaluator family raised under the aten-op recorder",
    "TORCH-F64": "float64/complex128 tensor inside a hot-path evaluator",
    "TORCH-WIDEN": "explicit dtype conversion widens within a kind",
    "TORCH-SYNC": "op inside the chunk makes the host wait for device "
                  "data (a host sync per chunk on the card)",
    "TORCH-H2D": "tensor made from host data inside the chunk (a "
                 "pageable host-to-device copy per call on the card)",
    "TORCH-UNUSED": "operand that no op reads — its value is baked in, "
                    "not an operand",
    "TORCH-SHRINK": "reduction tail does not shrink its inputs below "
                    "half, so chunk memory stops being O(block)",
    "TORCH-OPBUDGET": "per-family aten op count over budget",
    # concurrency linter (the reference's analysis/concurrency.py)
    "CONC-UNLOCKED": "shared attribute mutated outside the owning "
                     "lock/condition in a threaded module",
    "CONC-GLOBAL": "module-global rebound from a function in a "
                   "threaded module",
    "CONC-CONTEXTVAR": "ContextVar.set() without a matching reset()",
    "CONC-THREADLOCAL": "threading.local() built inside a function "
                        "(new storage per call, not per thread)",
    # spec/dataflow linter (analysis/speclint.py)
    "SPEC-PARSE": "dataflow program fails structural validation",
    "SPEC-ILLEGAL": "directive size/offset illegal for the layer dims",
    "SPEC-TILE": "steady temporal tile does not divide its dim extent "
                 "(edge phases; off the divisor-exact fast path)",
    "SPEC-CLUSTER": "cluster level illegal (empty inner level, or size "
                    "exceeds the PE array)",
    "SPEC-SPATIAL": "multiple SpatialMaps at one level are not aligned "
                    "(unequal sizes)",
    "SPEC-DIMS": "searched dim is not a (searchable) dim of the op",
    "SPEC-SPACE": "no legal mapping space for the query spec",
    "SPEC-BUDGET": "every mapping's working-set lower bound exceeds "
                   "the configured buffer budget (statically "
                   "infeasible search)",
}

SEVERITIES = ("error", "warn")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One static-analysis result.

    ``site`` is the stable waiver anchor (``module.py::Class.method`` or
    an analyzer-defined equivalent — never a line number, so findings
    survive unrelated edits); ``where`` carries the precise location for
    humans."""
    code: str
    site: str
    message: str
    severity: str = "error"
    analyzer: str = ""
    where: str = ""

    def __post_init__(self) -> None:
        if self.code not in CODES:
            raise ValueError(f"unregistered finding code {self.code!r}")
        if self.severity not in SEVERITIES:
            raise ValueError(f"bad severity {self.severity!r}")

    def to_json(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    def one_line(self) -> str:
        loc = self.where or self.site
        return f"{self.code} [{self.severity}] {loc}: {self.message}"


@dataclasses.dataclass(frozen=True)
class Waiver:
    """One intentional exception: excuses every finding whose (code,
    site) matches.  ``reason`` is mandatory — a waiver without a
    justification is a finding in itself."""
    code: str
    site: str
    reason: str

    def __post_init__(self) -> None:
        if self.code not in CODES:
            raise ValueError(f"waiver for unregistered code {self.code!r}")
        if not self.reason.strip():
            raise ValueError(f"waiver {self.code}@{self.site} needs a "
                             f"non-empty reason")

    def matches(self, f: Finding) -> bool:
        return f.code == self.code and f.site == self.site

    def to_json(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


DEFAULT_WAIVERS = os.path.join(os.path.dirname(__file__), "waivers.toml")


def load_waivers(path: str | None = None) -> list[Waiver]:
    """Parse ``waivers.toml`` (``[[waiver]]`` tables with ``code``,
    ``site``, ``reason``)."""
    path = path or DEFAULT_WAIVERS
    if not os.path.exists(path):
        return []
    with open(path, "rb") as f:
        doc = tomllib.load(f)
    out = []
    for row in doc.get("waiver", []):
        out.append(Waiver(code=row["code"], site=row["site"],
                          reason=row["reason"]))
    return out


def apply_waivers(findings: Sequence[Finding],
                  waivers: Iterable[Waiver]
                  ) -> tuple[list[Finding], list[Finding], list[Waiver]]:
    """Split findings into (unwaived, waived) and return the waivers
    that matched nothing — unused waivers fail CI (see module doc)."""
    waivers = list(waivers)
    used: set[int] = set()
    unwaived: list[Finding] = []
    waived: list[Finding] = []
    for f in findings:
        hit = False
        for i, w in enumerate(waivers):
            if w.matches(f):
                used.add(i)
                hit = True
        (waived if hit else unwaived).append(f)
    unused = [w for i, w in enumerate(waivers) if i not in used]
    return unwaived, waived, unused


def sort_findings(findings: Iterable[Finding]) -> list[Finding]:
    """Stable report order: errors first, then by site/code."""
    return sorted(findings,
                  key=lambda f: (SEVERITIES.index(f.severity),
                                 f.site, f.code, f.message))
