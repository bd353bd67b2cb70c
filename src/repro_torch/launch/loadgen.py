"""Load-generator CLI for the DSE serving tier (the port of
``repro.launch.loadgen``; a client only, it touches no device).

Drives N concurrent clients against a running
``repro_torch.launch.serve`` instance with the queries from a ``queries.json`` batch file, then
prints the terminal-status accounting and latency summary (and writes
it as JSON with ``--out``).  The acceptance bar it measures: every
request gets a terminal status — a report (including ``timeout`` /
``error`` kinds), a 429/503 shed, or a 400 reject — zero hangs, zero
unexplained drops.

Example::

    PYTHONPATH=src python -m repro_torch.launch.loadgen --port 8732 \
        --file examples/queries.json --clients 10 --requests 4
"""
from __future__ import annotations

import argparse
import asyncio
import json

from ..serve import http_json, http_text, run_loadgen

from .query import _write_json, cli_errors, configure_logging


def _load_queries(path: str) -> list[dict]:
    with open(path) as f:
        payload = json.load(f)
    if isinstance(payload, dict):
        payload = payload.get("queries", [])
    return list(payload)


async def _run(args) -> dict:
    queries = _load_queries(args.file)
    result = await run_loadgen(
        args.host, args.port, queries, clients=args.clients,
        requests_per_client=args.requests, timeout=args.timeout)
    summary = result.summary()
    if args.metricsz:
        _, snap = await http_json(args.host, args.port, "GET",
                                  "/metricsz")
        summary["server_metrics"] = snap
    if args.prometheus:
        _, text = await http_text(args.host, args.port, "GET",
                                  "/metricsz?format=prometheus")
        summary["server_prometheus"] = text
    if args.save_reports:
        # full report bodies (with extras.timing + request ids), to
        # reconcile against the server's histograms
        summary["reports"] = [{"query_index": qi, "report": body}
                              for qi, body in result.reports]
    return summary


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--file", default="examples/queries.json",
                    help="queries.json batch to draw requests from")
    ap.add_argument("--clients", type=int, default=10)
    ap.add_argument("--requests", type=int, default=4,
                    help="requests per client (round-robin over the "
                         "file's queries)")
    ap.add_argument("--timeout", type=float, default=120.0)
    ap.add_argument("--metricsz", action="store_true",
                    help="append the server's /metricsz snapshot")
    ap.add_argument("--prometheus", action="store_true",
                    help="append the server's Prometheus text "
                         "exposition (/metricsz?format=prometheus)")
    ap.add_argument("--save-reports", action="store_true",
                    help="embed every 200 report body in the summary "
                         "(per-request timing breakdowns)")
    ap.add_argument("--out", default=None,
                    help="write the summary JSON here")
    ap.add_argument("-v", "--verbose", action="count", default=0)
    ap.add_argument("-q", "--quiet", action="count", default=0)
    args = ap.parse_args(argv)
    configure_logging(args)
    with cli_errors():
        summary = asyncio.run(_run(args))
        # keep stdout readable: the bulky payloads only go to --out
        printed = {k: v for k, v in summary.items()
                   if k not in ("reports", "server_prometheus")}
        print(json.dumps(printed, indent=2))
        if args.out:
            _write_json(args.out, summary)


if __name__ == "__main__":
    main()
