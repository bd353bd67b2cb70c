"""repro_torch.analysis — static verification of dataflow-spec
invariants (the port of ``repro.analysis``).

One analyzer so far, on the shared :class:`Finding`/:class:`Waiver`
schema: :mod:`repro_torch.analysis.speclint`, the static legality of
dataflow programs and ``Query`` specs before any device work (the serving
tier's pre-admission lint and ``Query.lint``).  ``run_repo_lint`` runs it
over the shipped dataflow corpus; apply ``load_waivers``/``apply_waivers``
to honour a checked-in ``waivers.toml``.  The reference's concurrency
linter, its jaxpr audit (a graph audit of the evaluators here) and the
lint CLI are still to be ported.
"""
from __future__ import annotations

from .findings import (CODES, DEFAULT_WAIVERS, Finding, Waiver,
                       apply_waivers, load_waivers, sort_findings)

__all__ = ["CODES", "DEFAULT_WAIVERS", "Finding", "Waiver",
           "apply_waivers", "load_waivers", "run_repo_lint",
           "sort_findings"]


def run_repo_lint() -> list[Finding]:
    """The legality lint over the shipped dataflow corpus."""
    from . import speclint
    return sort_findings(speclint.lint_corpus())
