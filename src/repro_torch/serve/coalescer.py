"""Continuous cross-request coalescing: many clients, one device pass (the
port of ``repro.serve.coalescer``).

Admitted requests land in ONE buffer; a single flush worker drains it
in batches and answers every member through
:meth:`repro_torch.api.Session.run_many` — which folds coalescible layer
queries into shared (op-class, level-count) family spaces and evaluates
ALL their candidates in one padded gene-tensor device pass.  The flush
trigger is deadline-or-batch-size: a batch goes as soon as it is full
(``max_batch``) or its oldest member has waited ``flush_interval_s``,
so a lone request pays at most one interval of latency while a burst
pays one warm-up for the whole burst.

All engine work happens on the ONE worker thread (device-serial
anyway); the asyncio side only parks futures.  The worker runs on the
session's device: the current CUDA device is per thread, so the worker
makes the session's device current before its first flush, and the
batch's cancel scope (thread-local, like every scope of
``resilience.cancel_scope``) is opened by :func:`execute_batch` on the
worker itself.  :func:`execute_batch` is the single execution path
shared by the server's flush worker and the offline ``--file`` batch
CLI — which is what makes the offline run the oracle: the coalesced
server must answer bit-equal to ``repro_torch.launch.query --file`` on
the same query set.

Determinism contract: a flush batch answers bit-equal to the offline
batch of the SAME query set — family spaces are built over the distinct
layer shapes of a batch (class-level tile padding), so the unit of
bit-equality is the flush, not the individual request.  The server's
flush trigger is tuned so a concurrent wave lands in one flush; the
drain/recovery path re-executes the exact persisted set, which is what
makes a killed drain resume bit-identically.

Fault sites (see ``resilience.faultinject``): ``serve-flush`` fires at
the head of every batch execution (``slow@serve-flush`` stretches a
flush past deadlines), ``serve-worker`` fires in the worker loop around
it (``crash@serve-worker`` exercises the answer-with-error-reports
isolation path).
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Sequence

import torch

from .. import obs
from ..api import Query, Report, Session
from ..devices import resolve_device
from ..resilience import SweepKilled, cancel_scope, fault_point
from .deadline import Deadline, batch_deadline_t


def execute_batch(session: Session, queries: Sequence[Query], *,
                  coalesce: bool = True,
                  deadline_t: float | None = None) -> list[Report]:
    """THE batch execution path — server flushes and offline ``--file``
    batches both come through here, so their answers are bit-equal by
    construction.  ``deadline_t`` (absolute monotonic) bounds the whole
    pass via the engine's cooperative cancel scope, opened on the calling
    thread."""
    fault_point("serve-flush")
    with cancel_scope(deadline_t):
        return session.run_many(list(queries), coalesce=coalesce)


class _Pending:
    """One admitted request parked between admission and its answer."""

    __slots__ = ("query", "raw", "deadline", "resolve", "t_enqueue",
                 "t_enqueue_pc", "rid")

    def __init__(self, query: Query, raw: dict[str, Any],
                 deadline: Deadline,
                 resolve: Callable[[Report | BaseException], None],
                 rid: str | None = None):
        self.query = query
        self.raw = raw                 # wire-format dict (round-trips,
        #                                unlike Query.describe())
        self.deadline = deadline
        self.resolve = resolve         # thread-safe, idempotent
        self.t_enqueue = time.monotonic()
        self.t_enqueue_pc = time.perf_counter()  # for retroactive spans
        self.rid = rid or obs.new_request_id()


class Coalescer:
    """The admission buffer plus its single flush worker thread."""

    def __init__(self, session: Session, *, max_batch: int,
                 flush_interval_s: float, coalesce: bool = True,
                 on_kill: Callable[[], None] | None = None,
                 on_flush_done: Callable[[float], None] | None = None,
                 flight_dir: str | None = None):
        self.session = session
        self.max_batch = int(max_batch)
        self.flush_interval_s = float(flush_interval_s)
        self.coalesce = coalesce
        self.on_kill = on_kill          # SweepKilled escape hatch
        self.on_flush_done = on_flush_done   # feeds the admission EWMA
        self.flight_dir = flight_dir    # crash-dump target (None = off)
        self._cv = threading.Condition()
        self._buf: list[_Pending] = []
        self._in_flight: list[_Pending] = []
        self._stop = False
        self._flush_now = False
        self._killed = False
        self._thread = threading.Thread(target=self._run,
                                        name="serve-flush", daemon=True)

    # -- producer side (event loop) ------------------------------------

    def start(self) -> None:
        self._thread.start()

    def put(self, item: _Pending) -> None:
        with self._cv:
            self._buf.append(item)
            obs.metrics().gauge("serve.queue_depth", len(self._buf))
            self._cv.notify()

    def depth(self) -> int:
        """Admitted-but-unanswered requests (buffered + in flight) —
        the quantity the admission queue bound applies to."""
        with self._cv:
            return len(self._buf) + len(self._in_flight)

    def unanswered(self) -> list[_Pending]:
        """Snapshot of every request that has not been answered yet —
        what a draining server persists before its final flush."""
        with self._cv:
            return list(self._in_flight) + list(self._buf)

    def drain(self, timeout_s: float = 60.0) -> bool:
        """Flush everything buffered and wait for the worker to go
        idle; returns False on timeout (or a killed worker)."""
        deadline = time.monotonic() + timeout_s
        with self._cv:
            self._flush_now = True
            self._cv.notify()
            while self._buf or self._in_flight:
                if self._killed:
                    return False
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._cv.wait(timeout=min(left, 0.1))
        return True

    def stop(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify()
        if self._thread is not threading.current_thread():
            self._thread.join(timeout=5.0)

    def mark_killed(self) -> None:
        """Simulated process death from outside the worker (e.g.
        ``kill@serve-drain`` on the event loop): the worker must flush
        NOTHING further — parked requests stay unanswered, exactly like
        a dead process, until drain persistence + recovery replay
        them."""
        with self._cv:
            self._killed = True
            self._cv.notify_all()

    # -- worker side ---------------------------------------------------

    def _due_locked(self) -> bool:
        if not self._buf:
            return False
        if self._flush_now or len(self._buf) >= self.max_batch:
            return True
        return (time.monotonic() - self._buf[0].t_enqueue
                >= self.flush_interval_s)

    def _run(self) -> None:
        dev = resolve_device(self.session.device)
        if dev.type == "cuda" and dev.index is not None:
            # the current CUDA device is per thread: this one starts on
            # device 0 whatever the server's thread made current
            torch.cuda.set_device(dev)
        met = obs.metrics()
        while True:
            with self._cv:
                while not self._stop and not self._killed \
                        and not self._due_locked():
                    # bounded wait so a lone request's age trigger fires
                    self._cv.wait(timeout=self.flush_interval_s / 2)
                if self._killed or (self._stop and not self._buf):
                    return
                batch = self._buf[:self.max_batch]
                del self._buf[:len(batch)]
                self._in_flight = batch
                met.gauge("serve.queue_depth", len(self._buf))
            try:
                self._flush(batch)
            except SweepKilled:
                # injected process death in the flush path: leave every
                # unanswered request parked (the drain persistence +
                # sweep checkpoints carry them across the restart)
                with self._cv:
                    self._killed = True
                    self._cv.notify_all()
                if self.on_kill is not None:
                    self.on_kill()
                return
            finally:
                if not self._killed:
                    with self._cv:
                        self._in_flight = []
                        self._cv.notify_all()

    def _flush(self, batch: list[_Pending]) -> None:
        met = obs.metrics()
        # already-expired members answer without engine work
        live: list[_Pending] = []
        for p in batch:
            if p.deadline.expired():
                # serve.timeouts is counted once, at the response path
                rep = p.deadline.timeout_report(p.query, where="queued")
                self._finalize_timing(p, rep, time.monotonic())
                p.resolve(rep)
            else:
                live.append(p)
        if not live:
            return
        t0 = time.monotonic()
        t0_pc = time.perf_counter()
        met.inc("serve.flushes")
        met.inc("serve.flush_queries", len(live))
        met.observe("serve.batch_size", len(live))
        rids = [p.rid for p in live]
        tracer = obs.current_tracer()
        if tracer is not None:
            # retroactive per-request queue-wait spans: enqueue -> flush
            for p in live:
                tracer.emit_between("queue-wait", "serve",
                                    p.t_enqueue_pc, t0_pc,
                                    {"rid": p.rid})
        # the request scope rides the contextvar into Session.run_many
        # and the engine chunk loops on this (the flush worker) thread —
        # every span/flight entry below is attributable to these rids
        with obs.request_scope(*rids):
            try:
                fault_point("serve-worker")
                with obs.span("flush", cat="serve", queries=len(live)):
                    reports = execute_batch(
                        self.session, [p.query for p in live],
                        coalesce=self.coalesce,
                        deadline_t=batch_deadline_t(
                            [p.deadline for p in live]))
            except SweepKilled:
                raise
            except Exception as e:  # noqa: BLE001 — answered per request
                # run_many already isolates engine failures; anything
                # that still escapes (e.g. crash@serve-worker before it,
                # or a poisoned batch with degrade off) answers every
                # member with an error report instead of taking the
                # server down
                met.inc("serve.flush_errors")
                obs.instant("serve-flush-error", queries=len(live),
                            error=type(e).__name__)
                obs.flight_record("error", "serve-flush-error",
                                  error=type(e).__name__,
                                  message=str(e)[:200],
                                  queries=len(live))
                if self.flight_dir:
                    try:
                        obs.dump_flight(self.flight_dir, "flush-error",
                                        device=self.session.device,
                                        error=type(e).__name__,
                                        request_ids=rids)
                    except Exception:  # noqa: BLE001 — crash path
                        pass
                now = time.monotonic()
                for p in live:
                    rep = Report.from_error(p.query, e)
                    self._finalize_timing(p, rep, t0, now=now)
                    p.resolve(rep)
                return
        wall = time.monotonic() - t0
        if self.on_flush_done is not None:
            self.on_flush_done(wall)
        for p, rep in zip(live, reports):
            self._finalize_timing(p, rep, t0)
            p.resolve(rep)

    @staticmethod
    def _finalize_timing(p: _Pending, rep: Report, t_flush: float,
                         now: float | None = None) -> None:
        """Re-finalize the session-stamped ``timing`` breakdown with the
        server-side view: per-request ``queue_wait`` (enqueue -> flush
        start) joins the engine phases, wall becomes enqueue -> answer,
        and ``other`` re-absorbs the residual so the phases still sum to
        the wall latency the client experienced."""
        now = time.monotonic() if now is None else now
        prev = rep.extras.get("timing") or {}
        phases = dict(prev.get("phases") or {})
        phases.pop("other", None)
        phases["queue_wait"] = max(0.0, t_flush - p.t_enqueue)
        rep.extras["timing"] = obs.timing_breakdown(
            now - p.t_enqueue, phases, request_id=p.rid)
