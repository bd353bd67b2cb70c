"""AST-based concurrency linter for the threaded modules of ``repro_torch``
(the port's copy of ``repro.analysis.concurrency``: the same rules,
codes, messages and registry, so the two linters give the same findings
on any source).

The serving/observability stack made a handful of structures
thread-shared and load-bearing: the coalescer buffer, the admission
EWMA, the metrics registry, the tracer event list, the flight-recorder
ring, and the on-disk result cache's gauges.  This linter encodes the
locking discipline those modules promise and checks it statically:

* ``CONC-UNLOCKED`` — inside a registered threaded module, any mutation
  of ``self.<attr>`` (assignment, augmented assignment, subscript store,
  ``del``, or a mutating container-method call) outside a ``with
  self.<lock>``/``with <module lock>`` block, in a class that owns a
  ``threading.Lock``/``RLock``/``Condition``.  ``__init__``/``__new__``
  are construction-time and exempt; classes listed in the module policy
  as *unshared* (per-call objects, or helpers only ever touched under
  an owner's lock) are exempt by annotation.
* ``CONC-GLOBAL`` — a function in a threaded module rebinding a module
  global (single-writer toggles must be waived explicitly).
* ``CONC-CONTEXTVAR`` — repo-wide: a function calls ``.set()`` on a
  module-level ``ContextVar`` without ever calling ``.reset()`` on the
  same var (leaks request/phase context across asyncio tasks reusing a
  thread).
* ``CONC-THREADLOCAL`` — repo-wide: ``threading.local()`` constructed
  inside a function body (fresh storage per *call*, which defeats the
  point; build it at module/instance scope).

Adding a module to ``THREADED`` turns the locking rules on for it.  The
registry is the reference's, module for module.  Three other modules of
the port own a lock and stay out, as their counterparts stay out of the
reference's registry:

* ``mapspace/universal.py`` — ``_WARM_LOCK`` guards ``_WARMED`` inside
  ``warm_once`` only; registered, the module would flag the nine fields
  of ``GeneRun.merge``, which folds one evaluation's run record into
  another's on the thread that owns both;
* ``resilience/watchdog.py`` — every mutation already sits under its
  lock (registered, it gives no finding);
* ``resilience/faultinject.py`` — ``install``/``current``/``scoped``
  rebind the process's fault plan (``_CURRENT``, ``_ENV_READ``), read
  once from the environment or installed by a drill before its workers
  start, and ``scoped`` is a per-call context manager (registered, six
  findings of that kind).
"""
from __future__ import annotations

import ast
import dataclasses
import os
from typing import Iterable

from .findings import Finding

# Container methods that mutate their receiver in place.
_MUTATORS = frozenset({
    "append", "appendleft", "extend", "extendleft", "insert", "remove",
    "pop", "popleft", "popitem", "clear", "update", "add", "discard",
    "setdefault", "sort", "reverse", "rotate",
})

_LOCK_FACTORIES = frozenset({"Lock", "RLock", "Condition", "Semaphore",
                             "BoundedSemaphore"})


@dataclasses.dataclass(frozen=True)
class ModulePolicy:
    """Per-module annotation: which classes are exempt from the
    shared-mutation rule and why (per-call objects, or helpers that are
    only ever touched while an owner holds its lock)."""
    unshared: dict[str, str] = dataclasses.field(default_factory=dict)


# The threaded-module registry (relative to ``src/repro_torch/``).
THREADED: dict[str, ModulePolicy] = {
    "serve/coalescer.py": ModulePolicy(unshared={
        "_Pending": "request envelope: built by one handler task, "
                    "resolved once by the flush worker",
    }),
    "serve/admission.py": ModulePolicy(),
    "obs/metrics.py": ModulePolicy(unshared={
        "_Hist": "mutated only by Metrics methods holding Metrics._lock",
        "_BucketHist": "mutated only under Metrics._lock",
    }),
    "obs/trace.py": ModulePolicy(unshared={
        "_Span": "per-call context manager, never shared across threads",
        "_NullSpan": "stateless fast-path singleton",
    }),
    "obs/flightrec.py": ModulePolicy(),
    "obs/context.py": ModulePolicy(),
    "mapspace/cache.py": ModulePolicy(),
}


def _is_threading_call(node: ast.AST, names: Iterable[str]) -> bool:
    """``threading.X(...)`` or bare ``X(...)`` for X in names."""
    if not isinstance(node, ast.Call):
        return False
    fn = node.func
    if isinstance(fn, ast.Attribute) and isinstance(fn.value, ast.Name) \
            and fn.value.id == "threading" and fn.attr in names:
        return True
    return isinstance(fn, ast.Name) and fn.id in names


def _self_attr(node: ast.AST) -> str | None:
    """``self.x`` -> ``"x"``."""
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return None


def _mutation_targets(stmt: ast.stmt) -> list[tuple[str, int]]:
    """Shared-state mutations in one statement: (self attr, lineno).

    Covers ``self.x = ...``, ``self.x += ...``, ``self.x[i] = ...``,
    ``del self.x`` / ``del self.x[i]`` and ``self.x.append(...)``-style
    mutating calls."""
    out: list[tuple[str, int]] = []

    def base_attr(t: ast.AST) -> str | None:
        while isinstance(t, ast.Subscript):
            t = t.value
        return _self_attr(t)

    if isinstance(stmt, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
        targets = stmt.targets if isinstance(stmt, ast.Assign) \
            else [stmt.target]
        for t in targets:
            if isinstance(t, ast.Tuple):
                elts: list[ast.AST] = list(t.elts)
            else:
                elts = [t]
            for e in elts:
                a = base_attr(e)
                if a is not None:
                    out.append((a, stmt.lineno))
    elif isinstance(stmt, ast.Delete):
        for t in stmt.targets:
            a = base_attr(t)
            if a is not None:
                out.append((a, stmt.lineno))
    elif isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call):
        fn = stmt.value.func
        if isinstance(fn, ast.Attribute) and fn.attr in _MUTATORS:
            a = base_attr(fn.value)
            if a is not None:
                out.append((a, stmt.lineno))
    return out


def _with_locks(stmt: ast.With, lock_attrs: set[str],
                module_locks: set[str]) -> bool:
    """Does this ``with`` acquire one of the known locks?"""
    for item in stmt.items:
        e = item.context_expr
        a = _self_attr(e)
        if a is not None and a in lock_attrs:
            return True
        if isinstance(e, ast.Name) and e.id in module_locks:
            return True
        # ``with self._cv: ...`` vs ``with self._lock_for(x): ...`` —
        # a call on a lock attr (e.g. Condition.wait_for wrappers) does
        # not acquire; only the bare attr/name counts.
    return False


class _FuncChecker:
    """Walks one function body tracking lexical lock scope."""

    def __init__(self, lock_attrs: set[str], module_locks: set[str],
                 skip_attrs: set[str]) -> None:
        self.lock_attrs = lock_attrs
        self.module_locks = module_locks
        self.skip_attrs = skip_attrs
        self.unlocked: list[tuple[str, int]] = []

    def walk(self, body: list[ast.stmt], locked: bool) -> None:
        for stmt in body:
            if isinstance(stmt, ast.With):
                inner = locked or _with_locks(stmt, self.lock_attrs,
                                              self.module_locks)
                self.walk(stmt.body, inner)
                continue
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # nested function: conservatively checked in the outer
                # lock scope (closures in these modules run inline)
                self.walk(stmt.body, locked)
                continue
            if not locked:
                for attr, line in _mutation_targets(stmt):
                    if attr not in self.lock_attrs \
                            and attr not in self.skip_attrs:
                        self.unlocked.append((attr, line))
            # recurse into compound statements (if/for/try/while bodies)
            for field in ("body", "orelse", "finalbody", "handlers"):
                sub = getattr(stmt, field, None)
                if not sub:
                    continue
                if field == "handlers":
                    for h in sub:
                        self.walk(h.body, locked)
                else:
                    self.walk(sub, locked)


def _class_lock_attrs(cls: ast.ClassDef) -> set[str]:
    """Attrs assigned a threading lock/condition in ``__init__``."""
    out: set[str] = set()
    for node in cls.body:
        if isinstance(node, ast.FunctionDef) and node.name == "__init__":
            for stmt in ast.walk(node):
                if isinstance(stmt, ast.Assign) and \
                        _is_threading_call(stmt.value, _LOCK_FACTORIES):
                    for t in stmt.targets:
                        a = _self_attr(t)
                        if a is not None:
                            out.add(a)
    return out


def _module_locks(tree: ast.Module) -> set[str]:
    out: set[str] = set()
    for stmt in tree.body:
        if isinstance(stmt, ast.Assign) and \
                _is_threading_call(stmt.value, _LOCK_FACTORIES):
            for t in stmt.targets:
                if isinstance(t, ast.Name):
                    out.add(t.id)
    return out


def _module_contextvars(tree: ast.Module) -> set[str]:
    out: set[str] = set()
    for stmt in tree.body:
        if isinstance(stmt, ast.Assign) and \
                isinstance(stmt.value, ast.Call):
            fn = stmt.value.func
            name = fn.attr if isinstance(fn, ast.Attribute) else \
                fn.id if isinstance(fn, ast.Name) else None
            if name == "ContextVar":
                for t in stmt.targets:
                    if isinstance(t, ast.Name):
                        out.add(t.id)
    return out


def _func_qualnames(tree: ast.Module):
    """Yield (qualname, node) for every module/class-level function."""
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node.name, node
        elif isinstance(node, ast.ClassDef):
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef,
                                    ast.AsyncFunctionDef)):
                    yield f"{node.name}.{sub.name}", sub


# ----------------------------------------------------------------------
# Per-source linting
# ----------------------------------------------------------------------

def lint_source(src: str, rel: str,
                policy: ModulePolicy | None = None) -> list[Finding]:
    """Lint one module's source.  With a ``policy`` (a registered
    threaded module) the locking rules apply; the contextvar and
    threading.local rules apply regardless."""
    try:
        tree = ast.parse(src)
    except SyntaxError as e:
        return [Finding(code="CONC-GLOBAL", site=rel, severity="error",
                        analyzer="concurrency",
                        message=f"unparseable module: {e}")]
    findings: list[Finding] = []
    module_locks = _module_locks(tree)

    if policy is not None:
        findings += _lint_locking(tree, rel, policy, module_locks)

    findings += _lint_contextvars(tree, rel)
    findings += _lint_threadlocal(tree, rel)
    return findings


def _lint_locking(tree: ast.Module, rel: str, policy: ModulePolicy,
                  module_locks: set[str]) -> list[Finding]:
    findings: list[Finding] = []
    # classes
    for node in tree.body:
        if not isinstance(node, ast.ClassDef):
            continue
        if node.name in policy.unshared:
            continue
        lock_attrs = _class_lock_attrs(node)
        for fn in node.body:
            if not isinstance(fn, (ast.FunctionDef,
                                   ast.AsyncFunctionDef)):
                continue
            if fn.name in ("__init__", "__new__"):
                continue
            if any(isinstance(d, ast.Name) and d.id == "staticmethod"
                   for d in fn.decorator_list):
                continue
            chk = _FuncChecker(lock_attrs, module_locks, set())
            chk.walk(fn.body, locked=False)
            for attr, line in chk.unlocked:
                site = f"{rel}::{node.name}.{fn.name}"
                lock = "/".join(sorted(lock_attrs)) or "<no lock owned>"
                findings.append(Finding(
                    code="CONC-UNLOCKED", site=site,
                    analyzer="concurrency", where=f"{rel}:{line}",
                    message=f"self.{attr} mutated outside "
                            f"with self.{lock} in threaded module"))
    # module-global rebinding from functions
    for qual, fn in _func_qualnames(tree):
        declared: set[str] = set()
        for stmt in ast.walk(fn):
            if isinstance(stmt, ast.Global):
                declared.update(stmt.names)
        if not declared:
            continue
        chk_lines: list[tuple[str, int]] = []
        for stmt in ast.walk(fn):
            if isinstance(stmt, (ast.Assign, ast.AugAssign)):
                targets = stmt.targets if isinstance(stmt, ast.Assign) \
                    else [stmt.target]
                for t in targets:
                    if isinstance(t, ast.Name) and t.id in declared:
                        chk_lines.append((t.id, stmt.lineno))
        for gname, line in chk_lines:
            if gname in module_locks:
                continue
            findings.append(Finding(
                code="CONC-GLOBAL", site=f"{rel}::{qual}",
                analyzer="concurrency", where=f"{rel}:{line}",
                message=f"rebinds module global {gname} from a "
                        f"function in a threaded module"))
    return findings


def _lint_contextvars(tree: ast.Module, rel: str) -> list[Finding]:
    cvars = _module_contextvars(tree)
    if not cvars:
        return []
    findings: list[Finding] = []
    for qual, fn in _func_qualnames(tree):
        sets: dict[str, int] = {}
        resets: set[str] = set()
        for node in ast.walk(fn):
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    isinstance(node.func.value, ast.Name) and \
                    node.func.value.id in cvars:
                if node.func.attr == "set":
                    sets.setdefault(node.func.value.id, node.lineno)
                elif node.func.attr == "reset":
                    resets.add(node.func.value.id)
        for var, line in sets.items():
            if var not in resets:
                findings.append(Finding(
                    code="CONC-CONTEXTVAR", site=f"{rel}::{qual}",
                    analyzer="concurrency", where=f"{rel}:{line}",
                    message=f"{var}.set() without {var}.reset() — "
                            f"context leaks across tasks sharing the "
                            f"thread"))
    return findings


def _lint_threadlocal(tree: ast.Module, rel: str) -> list[Finding]:
    findings: list[Finding] = []
    for qual, fn in _func_qualnames(tree):
        if fn.name == "__init__":
            continue              # instance-scope storage is fine
        for node in ast.walk(fn):
            if _is_threading_call(node, {"local"}):
                findings.append(Finding(
                    code="CONC-THREADLOCAL", site=f"{rel}::{qual}",
                    analyzer="concurrency",
                    where=f"{rel}:{node.lineno}",
                    message="threading.local() inside a function body "
                            "creates fresh storage per call"))
    return findings


# ----------------------------------------------------------------------
# Tree walk
# ----------------------------------------------------------------------

def _src_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def lint_tree(root: str | None = None) -> list[Finding]:
    """Lint all of ``src/repro_torch/`` (or ``root``): locking rules on
    the registered threaded modules, contextvar/threading.local rules
    everywhere."""
    root = root or _src_root()
    findings: list[Finding] = []
    for dirpath, _dirnames, filenames in os.walk(root):
        for fname in sorted(filenames):
            if not fname.endswith(".py"):
                continue
            path = os.path.join(dirpath, fname)
            rel = os.path.relpath(path, root).replace(os.sep, "/")
            with open(path, encoding="utf-8") as f:
                src = f.read()
            findings += lint_source(src, rel, THREADED.get(rel))
    return findings
