"""Async load generator for the serving tier (client side of the wire;
the port's copy of ``repro.serve.loadgen``).

Drives N concurrent clients against a running :class:`DSEServer`, each
posting queries round-robin from a fixed set, and accounts for EVERY
request: terminal report kinds (layer/network/timeout/error), shed
statuses (429/503), bad requests, and transport failures — the
acceptance bar is zero requests without a terminal status.  Latency is
recorded per request; the summary carries p50/p99 and queries/s, which
is what the tests and ``chip_smoke.py`` assert on.

Stdlib-only: raw ``asyncio.open_connection`` HTTP/1.1 with
``Connection: close`` (one connection per request — the worst,
simplest client behaviour a public endpoint must absorb).
"""
from __future__ import annotations

import asyncio
import dataclasses
import json
import time
from typing import Any, Sequence


async def _http_raw(host: str, port: int, method: str, path: str,
                    payload: Any = None, *,
                    headers: dict[str, str] | None = None,
                    timeout: float = 60.0) -> tuple[int, bytes]:
    """One HTTP exchange; returns (status, raw response body)."""
    async def _go() -> tuple[int, bytes]:
        reader, writer = await asyncio.open_connection(host, port)
        try:
            body = b"" if payload is None else json.dumps(payload).encode()
            head = [f"{method} {path} HTTP/1.1", f"Host: {host}",
                    "Content-Type: application/json",
                    f"Content-Length: {len(body)}",
                    "Connection: close"]
            head += [f"{k}: {v}" for k, v in (headers or {}).items()]
            writer.write(("\r\n".join(head) + "\r\n\r\n").encode() + body)
            await writer.drain()
            raw = await reader.read()
            status = int(raw.split(b" ", 2)[1])
            _, _, resp = raw.partition(b"\r\n\r\n")
            return status, resp
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except Exception:  # noqa: BLE001
                pass
    return await asyncio.wait_for(_go(), timeout)


async def http_json(host: str, port: int, method: str, path: str,
                    payload: Any = None, *,
                    headers: dict[str, str] | None = None,
                    timeout: float = 60.0) -> tuple[int, Any]:
    """One HTTP exchange; returns (status, decoded JSON body)."""
    status, resp = await _http_raw(host, port, method, path, payload,
                                   headers=headers, timeout=timeout)
    return status, (json.loads(resp) if resp.strip() else None)


async def http_text(host: str, port: int, method: str, path: str, *,
                    headers: dict[str, str] | None = None,
                    timeout: float = 60.0) -> tuple[int, str]:
    """One HTTP exchange; returns (status, text body) — for the
    Prometheus ``/metricsz`` exposition."""
    status, resp = await _http_raw(host, port, method, path,
                                   headers=headers, timeout=timeout)
    return status, resp.decode("utf-8", "replace")


def _percentile(sorted_vals: list[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1, int(round(q * (len(sorted_vals) - 1))))
    return sorted_vals[i]


@dataclasses.dataclass
class LoadgenResult:
    n_requests: int
    statuses: dict[int, int]
    kinds: dict[str, int]              # report kind counts (status 200)
    transport_errors: int              # no HTTP response at all
    latencies_s: list[float]
    wall_s: float
    reports: list[Any]                 # (query index, report json) pairs

    @property
    def n_terminal(self) -> int:
        """Requests that got an explicit terminal status (any HTTP
        response counts — 200 report, 429/503 shed, 400 reject)."""
        return sum(self.statuses.values())

    def summary(self) -> dict[str, Any]:
        lat = sorted(self.latencies_s)
        return {
            "n_requests": self.n_requests,
            "n_terminal": self.n_terminal,
            "transport_errors": self.transport_errors,
            "statuses": {str(k): v for k, v in
                         sorted(self.statuses.items())},
            "kinds": dict(sorted(self.kinds.items())),
            "p50_s": round(_percentile(lat, 0.50), 4),
            "p99_s": round(_percentile(lat, 0.99), 4),
            "wall_s": round(self.wall_s, 3),
            "queries_per_s": round(self.n_requests / self.wall_s, 2)
            if self.wall_s > 0 else 0.0,
        }


async def run_loadgen(host: str, port: int,
                      queries: Sequence[dict], *,
                      clients: int = 10,
                      requests_per_client: int = 4,
                      timeout: float = 120.0) -> LoadgenResult:
    """N concurrent clients, each posting ``requests_per_client``
    queries round-robin from ``queries`` (wire-format dicts)."""
    statuses: dict[int, int] = {}
    kinds: dict[str, int] = {}
    latencies: list[float] = []
    reports: list[Any] = []
    transport_errors = 0
    lock = asyncio.Lock()

    async def client(ci: int) -> None:
        nonlocal transport_errors
        for ri in range(requests_per_client):
            # offset by client id so every concurrent wave spans the
            # whole query set (not N copies of one query)
            qi = (ci + ri) % len(queries)
            # deterministic client-minted request id — the server honors
            # it, so traces/flight dumps are attributable to (client,
            # request) without parsing response headers
            rid = f"lg-{ci:04d}-{ri:03d}"
            t0 = time.monotonic()
            try:
                status, body = await http_json(
                    host, port, "POST", "/query", queries[qi],
                    headers={"X-Request-Id": rid}, timeout=timeout)
            except Exception:  # noqa: BLE001 — accounted, not raised
                async with lock:
                    transport_errors += 1
                continue
            dt = time.monotonic() - t0
            async with lock:
                statuses[status] = statuses.get(status, 0) + 1
                latencies.append(dt)
                if status == 200 and isinstance(body, dict):
                    kind = body.get("kind", "?")
                    kinds[kind] = kinds.get(kind, 0) + 1
                    reports.append((qi, body))

    t0 = time.monotonic()
    await asyncio.gather(*(client(i) for i in range(clients)))
    wall = time.monotonic() - t0
    return LoadgenResult(
        n_requests=clients * requests_per_client, statuses=statuses,
        kinds=kinds, transport_errors=transport_errors,
        latencies_s=latencies, wall_s=wall, reports=reports)
