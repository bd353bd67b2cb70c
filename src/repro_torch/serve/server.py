"""The asyncio HTTP/JSON front of the DSE-as-a-service tier (the port of
``repro.serve.server``).

Stdlib-only (``asyncio.start_server`` + hand-rolled HTTP/1.1): one
long-lived :class:`repro_torch.api.Session` behind four routes —

  ``POST /query``     one query in the ``examples/queries.json`` wire
                      format; answers ``Report.to_json()`` (HTTP 200 —
                      including terminal ``timeout``/``error`` kinds),
                      429 + ``Retry-After`` when shed, 400 on a
                      malformed spec.
  ``GET /healthz``    process liveness (always 200 while running).
  ``GET /readyz``     200 only when admitting (503 while recovering or
                      draining) — the load-balancer signal.
  ``GET /metricsz``   the full ``Session.metrics()`` snapshot plus a
                      ``serve`` block (queue depth, EWMA flush seconds,
                      draining flag).  Content-negotiated: JSON by
                      default, Prometheus text exposition when the
                      ``Accept`` header asks for ``text/plain`` /
                      ``openmetrics`` or with ``?format=prometheus``.

Request observability: every ``POST /query`` gets a request id (an
inbound ``X-Request-Id`` is honored, else one is minted), echoed in the
``X-Request-Id`` response header, carried by contextvar through the
coalescer into the engine chunk loops, and stamped on every trace span,
flight-recorder entry, and the report's ``extras.timing`` breakdown.
The always-on flight recorder dumps its ring on unhandled handler
errors, flush crashes, kills, SIGQUIT, and backstop timeouts.

The server runs on its session's device, resolved when the server is
built: without a GPU a server whose session names no device raises
there, before it admits anything (pass ``Session(device="cpu")`` to
serve from the CPU).

Counter contract (test-asserted):
``serve.shed + serve.completed == serve.admitted`` — every well-formed
query request either sheds with an explicit 429/503 or completes with a
terminal report; ``serve.timeouts``/``serve.errors`` are subsets of
completed.  Malformed requests count ``serve.bad_requests`` and
statically-illegal ones (pre-admission
``repro_torch.analysis.speclint``)
count ``serve.speclint_rejected`` — both answer 400 and are outside
the invariant (never admitted).
"""
from __future__ import annotations

import asyncio
import dataclasses
import json
import logging
import os
import signal
import time
import urllib.parse
from typing import Any

from .. import obs
from ..api import Query, Report, Session
from ..devices import resolve_device
from ..resilience import SweepKilled, fault_point
from ..resilience.errors import SpecError
from .admission import AdmissionController
from .coalescer import Coalescer, _Pending
from .deadline import Deadline
from . import drain as drainmod

LOG = logging.getLogger("repro_torch.serve")

_MAX_HEADER = 64 * 1024
_MAX_BODY = 8 * 1024 * 1024


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Knobs of one server instance (defaults sized for the tiny-op CI
    smoke; production raises the queue/cost bounds)."""
    host: str = "127.0.0.1"
    port: int = 0                      # 0 = ephemeral (read server.port)
    max_queue: int = 64                # admitted-but-unanswered bound
    max_cost: float | None = 1e6       # estimated-cost shed gate
    max_batch: int = 16                # flush when this many buffered
    flush_interval_s: float = 0.05     # ... or when the oldest waited this
    default_deadline_s: float | None = 30.0
    grace_s: float = 2.0               # handler backstop past deadline
    coalesce: bool = True
    # kill@serve-drain semantics: a real server dies (os._exit — the
    # chaos drill wants actual process death mid-drain); in-process
    # tests flip this off so the "dead" server just stops, leaving its
    # pending file and sweep checkpoints for the restart to recover.
    exit_on_kill: bool = True
    # flight-recorder dump directory; None falls back to the session's
    # checkpoint dir, then $REPRO_TORCH_FLIGHT_DIR / the system temp dir
    flight_dir: str | None = None


def _json_bytes(payload: Any) -> bytes:
    return json.dumps(payload).encode()


class DSEServer:
    """One serving instance: admission -> coalescer -> session."""

    def __init__(self, session: Session, config: ServeConfig | None = None):
        # the device every flush runs on, resolved before anything is
        # admitted: a missing GPU raises here, never as error reports
        self.device = resolve_device(session.device)
        self.session = session
        self.config = config or ServeConfig()
        self.flight_dir = (self.config.flight_dir
                           or session.resilience.ckpt_dir
                           or obs.default_flight_dir())
        self.admission = AdmissionController(
            max_queue=self.config.max_queue,
            max_cost=self.config.max_cost)
        self.coalescer = Coalescer(
            session, max_batch=self.config.max_batch,
            flush_interval_s=self.config.flush_interval_s,
            coalesce=self.config.coalesce,
            on_kill=self._on_kill,
            on_flush_done=self.admission.note_flush,
            flight_dir=self.flight_dir)
        self.port: int | None = None
        self._server: asyncio.AbstractServer | None = None
        self._loop: asyncio.AbstractEventLoop | None = None
        self._ready = False
        self._draining = False
        self._killed = False
        self._signals: list[int] = []
        self._stopped = asyncio.Event()

    # -- lifecycle -----------------------------------------------------

    async def start(self) -> None:
        """Recover the previous process's debt (if any), start the
        flush worker, bind the socket, flip ready."""
        self._loop = asyncio.get_running_loop()
        ckpt = self.session.resilience.ckpt_dir
        if ckpt:
            await self._loop.run_in_executor(
                None, lambda: drainmod.recover(
                    self.session, ckpt, coalesce=self.config.coalesce))
        self.coalescer.start()
        # span capture into the flight-recorder ring: on for the life of
        # the server so a crash dump always carries recent engine spans
        obs.enable_flight_spans(True)
        self._server = await asyncio.start_server(
            self._handle, self.config.host, self.config.port)
        self.port = self._server.sockets[0].getsockname()[1]
        self._ready = True
        obs.instant("serve-start", port=self.port)
        LOG.info("serving on %s:%d", self.config.host, self.port)

    def install_signal_handlers(self) -> None:
        """SIGTERM/SIGINT -> graceful drain; SIGQUIT -> flight dump
        (the live-postmortem poke, process keeps serving)."""
        assert self._loop is not None
        for sig in (signal.SIGTERM, signal.SIGINT):
            self._loop.add_signal_handler(
                sig, lambda: asyncio.ensure_future(self.drain()))
        self._loop.add_signal_handler(
            signal.SIGQUIT, lambda: self._dump_flight("sigquit"))
        self._signals = [signal.SIGTERM, signal.SIGINT, signal.SIGQUIT]

    async def wait_stopped(self) -> None:
        await self._stopped.wait()

    async def drain(self) -> None:
        """The SIGTERM path: stop admitting, persist the unanswered
        queue, flush in-flight families, exit.  ``kill@serve-drain``
        fires between persist and flush — the mid-drain death the
        restart recovery drill exercises."""
        if self._draining:
            return
        self._draining = True
        self._ready = False
        met = obs.metrics()
        met.inc("serve.drains")
        ckpt = self.session.resilience.ckpt_dir
        raw = [p.raw for p in self.coalescer.unanswered()]
        if ckpt and raw:
            drainmod.persist_pending(ckpt, raw)
        try:
            fault_point("serve-drain")
        except SweepKilled:
            LOG.warning("killed mid-drain (injected) — pending queue "
                        "and sweep checkpoints left for recovery")
            self._on_kill()
            await self._shutdown()
            return
        assert self._loop is not None
        ok = await self._loop.run_in_executor(None, self.coalescer.drain)
        if ok and ckpt:
            drainmod.clear_pending(ckpt)
        # the tracer and metrics snapshot must survive SIGTERM — flush
        # them next to the checkpoint/flight artifacts before exit
        try:
            drainmod.save_observability(ckpt or self.flight_dir,
                                        self.metrics())
        except Exception:  # noqa: BLE001 — drain must complete anyway
            LOG.exception("saving drain observability failed")
        obs.instant("serve-drain-done", flushed=len(raw), clean=ok)
        await self._shutdown()

    async def stop(self) -> None:
        """Immediate stop (tests); does NOT drain."""
        await self._shutdown()

    async def _shutdown(self) -> None:
        self._ready = False
        if self._loop is not None:
            for sig in self._signals:       # give the process its own back
                self._loop.remove_signal_handler(sig)
        self._signals = []
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None
        self.coalescer.stop()
        obs.enable_flight_spans(False)
        self._stopped.set()

    def _dump_flight(self, reason: str, **info: Any) -> str | None:
        try:
            path = obs.dump_flight(self.flight_dir, reason,
                                   device=self.device, **info)
            LOG.warning("flight recorder dumped to %s (%s)", path, reason)
            return path
        except Exception:  # noqa: BLE001 — never compound a crash
            LOG.exception("flight dump failed")
            return None

    def _on_kill(self) -> None:
        """SweepKilled escaped a serve fault site: simulated process
        death."""
        self._killed = True
        self._ready = False
        self._dump_flight("killed")
        if self.config.exit_on_kill:
            os._exit(17)            # noqa: SLF001 — death IS the drill
        # in-process drill: the worker must answer nothing further
        self.coalescer.mark_killed()

    # -- introspection -------------------------------------------------

    def metrics(self) -> dict[str, Any]:
        snap = self.session.metrics()
        snap["serve"] = {
            "port": self.port,
            "ready": self._ready,
            "draining": self._draining,
            "queue_depth": self.coalescer.depth(),
            "ewma_flush_s": round(self.admission.ewma_flush_s, 4),
            "max_queue": self.config.max_queue,
            "max_batch": self.config.max_batch,
        }
        return snap

    # -- HTTP ----------------------------------------------------------

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            req = await asyncio.wait_for(_read_request(reader),
                                         timeout=30.0)
            if req is None:
                return
            method, path, query_string, req_headers, body = req
            status, headers, payload = await self._route(
                method, path, query_string, req_headers, body)
            await _respond(writer, status, headers, payload)
        except (asyncio.TimeoutError, ConnectionError,
                asyncio.IncompleteReadError):
            pass
        except Exception as e:  # noqa: BLE001 — a handler must never leak
            LOG.exception("request handler failed")
            obs.flight_record("error", "handler-error",
                              error=type(e).__name__,
                              message=str(e)[:200])
            self._dump_flight("handler-error", error=type(e).__name__)
            try:
                await _respond(writer, 500, {},
                               {"error": {"type": "internal"}})
            except Exception:  # noqa: BLE001
                pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:  # noqa: BLE001
                pass

    async def _route(self, method: str, path: str, query_string: str,
                     req_headers: dict[str, str], body: bytes
                     ) -> tuple[int, dict[str, str], Any]:
        if method == "GET" and path == "/healthz":
            return 200, {}, {"ok": True, "killed": self._killed}
        if method == "GET" and path == "/readyz":
            if self._ready and not self._draining:
                return 200, {}, {"ready": True}
            return 503, {}, {"ready": False,
                             "draining": self._draining}
        if method == "GET" and path == "/metricsz":
            if _wants_prometheus(query_string, req_headers):
                from ..obs.prom import CONTENT_TYPE, prometheus_text
                return 200, {"Content-Type": CONTENT_TYPE}, \
                    prometheus_text(self.metrics())
            return 200, {}, self.metrics()
        if method == "POST" and path == "/query":
            return await self._handle_query(req_headers, body)
        return 404, {}, {"error": {"type": "not_found", "path": path}}

    async def _handle_query(self, req_headers: dict[str, str],
                            body: bytes
                            ) -> tuple[int, dict[str, str], Any]:
        met = obs.metrics()
        met.inc("serve.requests")
        rid = (req_headers.get("x-request-id", "").strip()[:128]
               or obs.new_request_id())
        rid_h = {"X-Request-Id": rid}
        t_recv = time.monotonic()
        t_recv_pc = time.perf_counter()
        try:
            raw = json.loads(body.decode())
            query = Query.from_json(raw)
        except Exception as e:  # noqa: BLE001 — spec boundary
            met.inc("serve.bad_requests")
            msg = str(e).strip().splitlines()[0] if str(e).strip() else ""
            return 400, rid_h, {"error": {"type": type(e).__name__,
                                          "message": msg}}
        # pre-admission static lint (analysis.speclint): a query
        # that cannot possibly produce a result — bad searched dims,
        # unconstructible space, statically infeasible buffer budget —
        # is rejected here, before it can burn a flush slot.  Counted
        # separately from bad_requests and OUTSIDE the shed/completed
        # ledger (like bad_requests, it was never admitted).
        try:
            query.lint()
        except SpecError as e:
            met.inc("serve.speclint_rejected")
            return 400, rid_h, {"error": {
                "type": "SpecError",
                "message": str(e).strip().splitlines()[0],
                "findings": e.details.get("findings", [])}}
        met.inc("serve.admitted")

        with obs.request_scope(rid):
            retry = {"Retry-After":
                     str(self.admission.retry_after_s(
                         self.coalescer.depth(), self.config.max_batch)),
                     **rid_h}
            if self._draining or not self._ready:
                met.inc("serve.shed")
                met.inc("serve.shed_detail", reason="draining")
                return 503, retry, {"error": {"type": "draining"}}
            reason = self.admission.decide(query, self.coalescer.depth())
            if reason is not None:
                met.inc("serve.shed")
                met.inc("serve.shed_detail", reason=reason)
                obs.instant("serve-shed", reason=reason, tag=query.tag)
                payload = {"error": {"type": "overloaded",
                                     "reason": reason,
                                     "retry_after_s":
                                         int(retry["Retry-After"])}}
                if reason == "cost":
                    payload["error"]["estimated_cost"] = \
                        query.estimated_cost()
                    payload["error"]["max_cost"] = self.admission.max_cost
                return 429, retry, payload

            deadline = Deadline.stamp(query,
                                      self.config.default_deadline_s)
            assert self._loop is not None
            fut: asyncio.Future = self._loop.create_future()
            self.coalescer.put(_Pending(query, raw, deadline,
                                        _resolver(self._loop, fut),
                                        rid=rid))
            remaining = deadline.remaining()
            timeout = None if remaining is None \
                else max(remaining, 0.0) + self.config.grace_s
            try:
                rep: Report = await asyncio.wait_for(fut, timeout)
            except asyncio.TimeoutError:
                # backstop: the engine is still holding the batch (or
                # died) past budget + grace; the client gets a terminal
                # timeout report NOW, whatever the worker is doing
                rep = deadline.timeout_report(query, where="in-flight")
                rep.extras["timing"] = obs.timing_breakdown(
                    time.monotonic() - t_recv, {}, request_id=rid)
                obs.flight_record("error", "backstop-timeout", rid=rid,
                                  tag=query.tag)
                try:
                    obs.flight_recorder().maybe_dump(
                        self.flight_dir, "backstop-timeout",
                        device=self.device, request_ids=[rid])
                except Exception:  # noqa: BLE001 — crash path
                    pass
            met.inc("serve.completed")
            if rep.kind == "timeout":
                met.inc("serve.timeouts")
            elif rep.kind == "error":
                met.inc("serve.errors")
            self._observe_slo(rep, rid, time.monotonic() - t_recv)
            tracer = obs.current_tracer()
            if tracer is not None:
                # the whole request as one retroactive span: receive ->
                # response, the parent row a Perfetto query follows
                tracer.emit_between(
                    "request", "serve", t_recv_pc, time.perf_counter(),
                    {"rid": rid, "kind": rep.kind, "tag": query.tag})
            return 200, rid_h, rep.to_json()

    @staticmethod
    def _observe_slo(rep: Report, rid: str, wall_s: float) -> None:
        """SLO histograms: end-to-end latency per report kind, plus the
        per-phase breakdown — both with the request id as exemplar, so
        a p99 bucket names a concrete request to go trace."""
        met = obs.metrics()
        met.observe_bucketed("serve.latency_s", wall_s, kind=rep.kind,
                             exemplar=rid)
        timing = rep.extras.get("timing")
        for phase, v in (timing or {}).get("phases", {}).items():
            met.observe_bucketed("serve.phase_s", v, phase=phase,
                                 exemplar=rid)


def _resolver(loop: asyncio.AbstractEventLoop, fut: asyncio.Future):
    """Thread-safe, idempotent future resolution from the flush
    worker."""
    def resolve(result) -> None:
        def _set() -> None:
            if fut.done():
                return             # handler already answered (timeout)
            if isinstance(result, BaseException):
                fut.set_exception(result)
            else:
                fut.set_result(result)
        try:
            loop.call_soon_threadsafe(_set)
        except RuntimeError:
            pass               # loop closed — the handler is long gone
    return resolve


def _wants_prometheus(query_string: str,
                      headers: dict[str, str]) -> bool:
    """Content negotiation for ``/metricsz``: JSON by default (every
    existing consumer), Prometheus text on explicit request."""
    fmt = urllib.parse.parse_qs(query_string).get("format", [""])[0]
    if fmt:
        return fmt == "prometheus"
    accept = headers.get("accept", "")
    return "text/plain" in accept or "openmetrics" in accept


async def _read_request(reader: asyncio.StreamReader
                        ) -> tuple[str, str, str, dict[str, str],
                                   bytes] | None:
    """Minimal HTTP/1.1 request parser: request line, headers,
    Content-Length body.  Returns ``(method, path, query_string,
    headers, body)`` with header names lowercased, or None on an empty
    connection."""
    line = await reader.readline()
    if not line.strip():
        return None
    parts = line.decode("latin1").split()
    if len(parts) < 2:
        raise ValueError(f"bad request line: {line!r}")
    method, target = parts[0].upper(), parts[1]
    headers: dict[str, str] = {}
    length = 0
    total = len(line)
    while True:
        h = await reader.readline()
        total += len(h)
        if total > _MAX_HEADER:
            raise ValueError("headers too large")
        if h in (b"\r\n", b"\n", b""):
            break
        name, _, value = h.decode("latin1").partition(":")
        headers[name.strip().lower()] = value.strip()
        if name.strip().lower() == "content-length":
            length = int(value.strip())
    if length > _MAX_BODY:
        raise ValueError("body too large")
    body = await reader.readexactly(length) if length else b""
    path, _, query_string = target.partition("?")
    return method, path, query_string, headers, body


async def _respond(writer: asyncio.StreamWriter, status: int,
                   headers: dict[str, str], payload: Any) -> None:
    reason = {200: "OK", 400: "Bad Request", 404: "Not Found",
              429: "Too Many Requests", 500: "Internal Server Error",
              503: "Service Unavailable"}.get(status, "OK")
    headers = dict(headers)
    if isinstance(payload, (str, bytes)):
        body = payload.encode() if isinstance(payload, str) else payload
        ctype = headers.pop("Content-Type",
                            "text/plain; charset=utf-8")
    else:
        body = _json_bytes(payload)
        ctype = headers.pop("Content-Type", "application/json")
    head = [f"HTTP/1.1 {status} {reason}",
            f"Content-Type: {ctype}",
            f"Content-Length: {len(body)}",
            "Connection: close"]
    head += [f"{k}: {v}" for k, v in headers.items()]
    writer.write(("\r\n".join(head) + "\r\n\r\n").encode() + body)
    await writer.drain()
