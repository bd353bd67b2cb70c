"""The DSE-as-a-service server CLI — ``Session`` behind HTTP/JSON, on
PyTorch (the port of ``repro.launch.serve``).  It serves from ``cuda``
unless ``--device`` names another device, and raises at start without
one; there is no ``--jax-cache-dir`` (the port compiles nothing).

Wire format: ``POST /query`` takes ONE query dict in the
``examples/queries.json`` schema and answers ``Report.to_json()``;
``GET /healthz`` / ``/readyz`` / ``/metricsz`` serve liveness,
readiness, and the structured metrics snapshot.  SIGTERM drains
gracefully: admission stops, the unanswered queue is persisted, and
in-flight families flush over sweep checkpoints so a killed drain
resumes bit-identically on restart.

Examples::

    # serve on a fixed port with checkpointed drains, on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --port 8732 \\
        --checkpoint-dir /tmp/serve-ckpt

    # the same from the CPU
    PYTHONPATH=src python -m repro_torch.launch.serve --port 8732 \\
        --device cpu

    # chaos drill: die mid-drain, then restart to recover
    PYTHONPATH=src python -m repro_torch.launch.serve --port 8732 \\
        --checkpoint-dir /tmp/serve-ckpt --faults kill@serve-drain
"""
from __future__ import annotations

import argparse
import asyncio

from ..serve import DSEServer, ServeConfig
from .query import (DEFAULT_CACHE, LOG, add_obs_args, cli_errors,
                    obs_scope, session_from_args)


def add_serve_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="0 = ephemeral (printed at startup)")
    ap.add_argument("--max-queue", type=int, default=64,
                    help="admitted-but-unanswered bound; beyond it "
                         "requests shed with 429 + Retry-After")
    ap.add_argument("--max-cost", type=float, default=1e6,
                    help="estimated-cost shed gate (0 disables)")
    ap.add_argument("--max-batch", type=int, default=16,
                    help="flush when this many requests are buffered")
    ap.add_argument("--flush-interval", type=float, default=0.05,
                    metavar="S",
                    help="... or when the oldest waited this long")
    ap.add_argument("--deadline", type=float, default=30.0, metavar="S",
                    help="default per-request budget for queries that "
                         "carry no search.deadline_s (0 = unbounded)")
    ap.add_argument("--no-coalesce", action="store_true",
                    help="flush each request separately (oracle mode)")
    ap.add_argument("--devices", type=int, default=None,
                    help="CUDA devices to stripe evaluation over "
                         "(default: all)")
    ap.add_argument("--device", default=None,
                    help="where to serve from (default cuda; 'cpu' on "
                         "request)")
    ap.add_argument("--cache-dir", default=DEFAULT_CACHE)
    ap.add_argument("--checkpoint-dir", default=None, metavar="DIR",
                    help="drain persistence + sweep checkpoints: a "
                         "killed drain resumes bit-identically here")
    ap.add_argument("--faults", default=None, metavar="SPEC",
                    help="deterministic fault injection (serve sites: "
                         "slow@serve-flush, crash@serve-worker, "
                         "kill@serve-drain)")
    add_obs_args(ap)
    # --flight-dir comes from add_obs_args; the server also falls back
    # to --checkpoint-dir, then $REPRO_TORCH_FLIGHT_DIR / tmp


def config_from_args(args) -> ServeConfig:
    return ServeConfig(
        host=args.host, port=args.port,
        max_queue=args.max_queue,
        max_cost=args.max_cost if args.max_cost > 0 else None,
        max_batch=args.max_batch,
        flush_interval_s=args.flush_interval,
        default_deadline_s=args.deadline if args.deadline > 0 else None,
        coalesce=not args.no_coalesce,
        flight_dir=getattr(args, "flight_dir", None))


async def _serve(args) -> None:
    session = session_from_args(args)
    server = DSEServer(session, config_from_args(args))
    await server.start()
    server.install_signal_handlers()
    LOG.warning("ready on http://%s:%d (POST /query; SIGTERM drains)",
                args.host, server.port)
    await server.wait_stopped()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_serve_args(ap)
    args = ap.parse_args(argv)
    with cli_errors(), obs_scope(args):
        asyncio.run(_serve(args))


if __name__ == "__main__":
    main()
