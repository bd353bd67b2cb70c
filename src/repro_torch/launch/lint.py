"""``python -m repro_torch.launch.lint`` — run the static analyzers.

The zero-findings gate: exit 0 only when every finding is covered by a
checked-in waiver (``src/repro_torch/analysis/waivers.toml``) AND every
waiver still matches something (an unused waiver means the code was
fixed — delete the waiver).

Examples::

    # everything on the card: repo lint + dataflow corpus + graph audit
    PYTHONPATH=src python -m repro_torch.launch.lint

    # the same on the CPU (the audit's findings are the card's: host
    # syncs and host-made tensors are detected by op)
    PYTHONPATH=src python -m repro_torch.launch.lint --device cpu

    # the cheap pass: no evaluator runs
    PYTHONPATH=src python -m repro_torch.launch.lint --device cpu --no-audit

    # machine-readable findings (Report.bench schema, with the
    # environment block of the device)
    PYTHONPATH=src python -m repro_torch.launch.lint --json --out lint.json
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Sequence

from ..analysis import (apply_waivers, load_waivers, run_full,
                        run_repo_lint, sort_findings)
from ..devices import resolve_device

from .query import LOG, _write_json, cli_errors, configure_logging


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="repro_torch.launch.lint",
        description="static analysis: concurrency lint, dataflow-spec "
                    "lint, graph audit of the universal evaluators")
    ap.add_argument("--no-audit", action="store_true",
                    help="skip the graph audit (no evaluator runs; the "
                         "cheap pre-commit pass)")
    ap.add_argument("--device", default="cuda",
                    help="device the audit runs its evaluators on "
                         "(default cuda; raises without a GPU, pass "
                         "--device cpu to run on the CPU)")
    ap.add_argument("--waivers", default=None, metavar="FILE",
                    help="waiver file (default: the checked-in "
                         "analysis/waivers.toml)")
    ap.add_argument("--json", action="store_true",
                    help="print the findings report as JSON "
                         "(Report.bench schema) instead of lines")
    ap.add_argument("--out", default=None, metavar="FILE",
                    help="also write the JSON report to FILE")
    ap.add_argument("-v", "--verbose", action="count", default=0)
    ap.add_argument("-q", "--quiet", action="count", default=0)
    return ap


def main(argv: Sequence[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    configure_logging(args)
    device = resolve_device(args.device)
    with cli_errors():
        report: dict = {}
        if args.no_audit:
            findings = run_repo_lint()
        else:
            findings, report = run_full(device)
        waivers = load_waivers(args.waivers)
        if args.no_audit:
            # the audit's waivers have nothing to match without it
            waivers = [w for w in waivers if not w.code.startswith("TORCH-")]
        unwaived, waived, unused = apply_waivers(findings, waivers)
        unwaived = sort_findings(unwaived)

        payload = {
            "n_findings": len(findings),
            "n_unwaived": len(unwaived),
            "n_waived": len(waived),
            "unused_waivers": [f"{w.code} @ {w.site}" for w in unused],
            "findings": [f.to_json() for f in unwaived],
            "waived": [f.to_json() for f in waived],
            "audit": report,
        }
        if args.json or args.out:
            from ..api import Report
            doc = Report.bench("lint", payload, device=device).to_json()
            if args.json:
                print(json.dumps(doc, indent=2))
            if args.out:
                _write_json(args.out, doc)
        if not args.json:
            for f in unwaived:
                print(f.one_line())
            LOG.info("lint: %d finding(s), %d unwaived, %d waived, "
                     "%d unused waiver(s)", len(findings), len(unwaived),
                     len(waived), len(unused))
        for w in unused:
            print(f"unused waiver: {w.code} @ {w.site} — the finding "
                  f"is gone, delete the waiver", file=sys.stderr)
        return 1 if unwaived or unused else 0


if __name__ == "__main__":
    raise SystemExit(main())
