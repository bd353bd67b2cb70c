"""Deterministic fault injection for the sweep execution layer.

A :class:`FaultInjector` is configured from a spec string (the
``REPRO_FAULTS`` env var, :func:`install` or :class:`scoped`) and fired
from instrumented *fault points* inside the chunk loops.  Because the
points are indexed by a deterministic per-site counter, "crash on chunk
3" means the same chunk on every run — every recovery path is
exercisable in tests without flakes.

Spec grammar (comma-separated directives)::

    kind@site:index[:arg][xN]

    crash@chunk:3        raise InjectedFault at the 4th chunk fault point
    oom@chunk:2          raise InjectedOOM (message matches is_oom)
    kill@chunk:5         raise SweepKilled — NOT retried; simulates
                         process death for checkpoint/resume tests
    slow@chunk:1:0.25    sleep 0.25 s at chunk 1 (straggler injection)
    truncate@checkpoint:0  truncate the checkpoint file written by save 0
    crash@chunk:3x2      fire twice (chunks 3 and 4), i.e. also defeats
                         one retry

Sites in the port: ``chunk`` (``mapspace.universal.evaluate_genes``
device chunks), ``design-chunk`` (``mapspace.codse.joint_sweep``),
``checkpoint`` (``SweepCheckpoint.save``), and the serving tier's
``serve-flush`` (head of every batch execution), ``serve-worker`` (the
flush worker) and ``serve-drain`` (between a drain's persist and its
final flush).  Every firing increments
``resilience.faults_injected``.
"""
from __future__ import annotations

import dataclasses
import os
import threading
import time

from .. import obs


class InjectedFault(RuntimeError):
    """A deliberately injected failure (retryable)."""


class InjectedOOM(InjectedFault):
    """Injected device-memory exhaustion; the message carries the XLA
    RESOURCE_EXHAUSTED marker so ``errors.is_oom`` routes it to the
    chunk-split path exactly like a real OOM."""

    def __init__(self, site: str, index: int):
        super().__init__(
            f"RESOURCE_EXHAUSTED: injected OOM at {site}:{index}")


class SweepKilled(InjectedFault):
    """Injected process death.  Never retried or degraded — it must
    propagate so checkpoint/resume tests observe a genuine mid-sweep
    kill."""


@dataclasses.dataclass
class _Directive:
    kind: str            # crash | oom | kill | slow | truncate
    site: str
    index: int
    arg: float = 0.0
    times: int = 1

    def spec(self) -> str:
        s = f"{self.kind}@{self.site}:{self.index}"
        if self.arg:
            s += f":{self.arg:g}"
        if self.times != 1:
            s += f"x{self.times}"
        return s


_KINDS = ("crash", "oom", "kill", "slow", "truncate")


def parse(spec: str) -> list[_Directive]:
    out = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        kind, _, rest = part.partition("@")
        if kind not in _KINDS or not rest:
            raise ValueError(f"bad fault directive {part!r} "
                             f"(want kind@site:index, kind in {_KINDS})")
        times = 1
        if "x" in rest.rsplit(":", 1)[-1]:
            rest, _, t = rest.rpartition("x")
            times = int(t)
        bits = rest.split(":")
        if len(bits) < 2:
            raise ValueError(f"bad fault directive {part!r}: missing index")
        site, index = bits[0], int(bits[1])
        arg = float(bits[2]) if len(bits) > 2 else 0.0
        out.append(_Directive(kind, site, index, arg, times))
    return out


class FaultInjector:
    """Holds parsed directives plus a per-site call counter; thread-safe
    (the async chunk loops collect from one thread, but netspace +
    Session may share the process-wide injector)."""

    def __init__(self, spec: str = ""):
        self._lock = threading.Lock()
        self.directives = parse(spec) if spec else []
        self._counts: dict[str, int] = {}
        self.fired = 0

    def active(self) -> bool:
        return any(d.times > 0 for d in self.directives)

    def fire(self, site: str, index: int | None = None,
             path: str | None = None) -> None:
        """Evaluate the fault point ``site`` (indexed by an internal
        per-site counter unless ``index`` is given).  Raises / sleeps /
        truncates ``path`` when a directive matches; no-op otherwise."""
        with self._lock:
            if index is None:
                index = self._counts.get(site, 0)
                self._counts[site] = index + 1
            hit = None
            for d in self.directives:
                if d.site == site and d.times > 0 and d.index <= index \
                        < d.index + d.times:
                    hit = d
                    break
            if hit is None:
                return
        obs.metrics().inc("resilience.faults_injected",
                          kind=hit.kind, site=site)
        obs.instant("fault-injected", kind=hit.kind, site=site, index=index)
        if hit.kind == "slow":
            time.sleep(hit.arg)
        elif hit.kind == "truncate":
            if path and os.path.exists(path):
                keep = max(1, os.path.getsize(path) // 2)
                with open(path, "r+b") as f:
                    f.truncate(keep)
        elif hit.kind == "oom":
            raise InjectedOOM(site, index)
        elif hit.kind == "kill":
            raise SweepKilled(f"injected kill at {site}:{index}")
        else:
            raise InjectedFault(f"injected crash at {site}:{index}")


_NULL = FaultInjector()
_CURRENT: FaultInjector = _NULL
_ENV_READ = False


def install(spec: str | None) -> FaultInjector:
    """Install a process-wide injector from a spec string (or clear with
    None/empty).  Returns the installed injector."""
    global _CURRENT, _ENV_READ
    _ENV_READ = True         # explicit install overrides the env knob
    _CURRENT = FaultInjector(spec) if spec else _NULL
    return _CURRENT


def clear() -> None:
    install(None)


def current() -> FaultInjector:
    """The active injector; reads ``REPRO_FAULTS`` once on first use."""
    global _CURRENT, _ENV_READ
    if not _ENV_READ:
        _ENV_READ = True
        env = os.environ.get("REPRO_FAULTS", "")
        if env:
            _CURRENT = FaultInjector(env)
    return _CURRENT


def fault_point(site: str, index: int | None = None,
                path: str | None = None) -> None:
    """The hook the chunk loops call; free when no injector is active."""
    inj = current()
    if inj.directives:
        inj.fire(site, index, path)


class scoped:
    """``with faultinject.scoped("kill@chunk:1"):`` — test helper that
    installs a fresh injector and restores the previous one on exit."""

    def __init__(self, spec: str):
        self.spec = spec

    def __enter__(self) -> FaultInjector:
        global _CURRENT
        self._prev = _CURRENT
        return install(self.spec)

    def __exit__(self, *exc) -> None:
        global _CURRENT
        _CURRENT = self._prev
