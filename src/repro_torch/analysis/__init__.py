"""repro_torch.analysis — static verification of engine, concurrency, and
dataflow-spec invariants (the port of ``repro.analysis``).

Three analyzers share one :class:`Finding`/:class:`Waiver` schema and
one CLI (``python -m repro_torch.launch.lint``):

* :mod:`repro_torch.analysis.concurrency` — AST linter over
  ``src/repro_torch/`` for unlocked shared-state mutation in the threaded
  modules;
* :mod:`repro_torch.analysis.speclint` — static legality of dataflow
  programs and ``Query`` specs before any device work;
* :mod:`repro_torch.analysis.graph_audit` — an aten-op audit of every
  universal evaluator family (float64, widening, host syncs, host-made
  operands by site, unread operands, the reduce tail's shrink, an op
  budget), the counterpart of the reference's jaxpr audit.

``run_repo_lint`` is the cheap pass (concurrency + shipped dataflow
corpus, no tensor built); ``run_full`` adds the graph audit on a device.
Both return raw findings — apply ``load_waivers``/``apply_waivers`` to
honour the checked-in ``waivers.toml``.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Any

from .findings import (CODES, DEFAULT_WAIVERS, Finding, Waiver,
                       apply_waivers, load_waivers, sort_findings)

if TYPE_CHECKING:
    import torch

__all__ = ["CODES", "DEFAULT_WAIVERS", "Finding", "Waiver",
           "apply_waivers", "load_waivers", "run_full", "run_repo_lint",
           "sort_findings"]


def run_repo_lint() -> list[Finding]:
    """The cheap analyzers: concurrency lint over the source tree +
    legality lint over the shipped dataflow corpus."""
    from . import concurrency, speclint
    return sort_findings(concurrency.lint_tree() + speclint.lint_corpus())


def run_full(device: "str | torch.device | None" = None
             ) -> tuple[list[Finding], dict[str, Any]]:
    """Everything: repo lint + the graph audit on ``device`` (``cuda``
    unless the caller asks for another).  Returns the findings and the
    audit's per-case report."""
    from . import graph_audit
    findings = run_repo_lint()
    audit_findings, report = graph_audit.audit(device)
    return sort_findings(findings + audit_findings), report
