"""Concurrency-discipline rules.

Scope: the modules that actually face more than one thread — the scheduler
cycle driver and its caches (cycle.py, snapshot_cache.py, frameworkext.py),
the event-sourced object store, the koordlet daemon tree (metrics
collectors, hook server, states informer all run threads), the
runtimeproxy servers, and the obs/ tracing layer (its finished-root ring
is shared across every traced thread). Everywhere else a module-level
dict is usually an import-time registry and flagging it would be noise,
so the rules gate on the module path.

Rules:

  * shared-mutable-global — a module-level mutable container that some
    function in the module writes (subscript/augassign/mutating method)
    outside any ``with <lock>`` block. Import-time registration patterns
    live outside the gated paths and stay legal.
  * unlocked-shared-mutation — inside a class that starts threads/timers,
    a method (other than __init__/_init*, which run happens-before the
    spawn) mutating ``self.<attr>`` outside a ``with <lock-ish>`` block.
  * except-swallow — a bare ``except:`` or an ``except Exception`` whose
    whole body is pass/continue/...: the scheduler's correctness story
    leans on loud failure (parity tests, exactness contracts); silently
    eating BaseException-adjacent errors hides the exact bugs the rest of
    this linter exists to surface.
  * silent-exception-swallow — the ERROR-severity version for the
    dispatch-critical paths (scheduler/, obs/, parallel/, sim/): a broad
    handler whose body only pass/continue/returns-a-constant, with no
    raise, no log, no metric. The degradation ladder turned "dispatch
    failure" into control flow there, so an unobserved swallow doesn't
    just hide a bug — it can mask the exact signal the ladder, the
    flight recorder, and the sim's fault plan exist to surface (the
    koordlet device probe swallowed exactly this way for six PRs).
"""

from __future__ import annotations

import ast
import re
from typing import Iterator, List, Optional, Set

from koordinator_tpu_torch.analysis.core import (
    Finding,
    ModuleContext,
    Rule,
    register,
)

# path fragments that mark a module as concurrency-sensitive
_CONCURRENT_PATH_RE = re.compile(
    r"(koordlet/|runtimeproxy/|(^|/)obs/|client/store\.py"
    r"|scheduler/cycle\.py"
    r"|scheduler/snapshot_cache\.py|scheduler/frameworkext\.py)")

_LOCKISH_RE = re.compile(r"(lock|mutex|cond|sem|rlock)", re.IGNORECASE)

_MUTATING_METHODS = {
    "append", "add", "update", "pop", "setdefault", "clear", "extend",
    "remove", "insert", "popitem", "discard", "appendleft",
}

_MUTABLE_CTORS = {"dict", "list", "set", "defaultdict", "deque",
                  "OrderedDict", "Counter"}

_FUNC_DEFS = (ast.FunctionDef, ast.AsyncFunctionDef)


def is_concurrent_path(path: str) -> bool:
    return _CONCURRENT_PATH_RE.search(path) is not None


def _is_mutable_literal(node: ast.AST) -> bool:
    if isinstance(node, (ast.Dict, ast.List, ast.Set, ast.ListComp,
                         ast.DictComp, ast.SetComp)):
        return True
    if isinstance(node, ast.Call):
        f = node.func
        name = f.id if isinstance(f, ast.Name) else (
            f.attr if isinstance(f, ast.Attribute) else "")
        return name in _MUTABLE_CTORS
    return False


def _lock_held(ctx: ModuleContext, node: ast.AST) -> bool:
    """Is `node` lexically inside a ``with <something lock-ish>`` block?"""
    parents = ctx.parent_map()
    cur: Optional[ast.AST] = node
    while cur is not None:
        if isinstance(cur, (ast.With, ast.AsyncWith)):
            for item in cur.items:
                expr = item.context_expr
                # with self._lock:  /  with lock:  /  with self.lock.gen():
                for sub in ast.walk(expr):
                    name = ""
                    if isinstance(sub, ast.Attribute):
                        name = sub.attr
                    elif isinstance(sub, ast.Name):
                        name = sub.id
                    if name and _LOCKISH_RE.search(name):
                        return True
        cur = parents.get(cur)
    return False


def _mutation_target(node: ast.AST) -> Optional[ast.AST]:
    """If `node` writes a container, return the expression it writes."""
    if isinstance(node, ast.Assign):
        for t in node.targets:
            if isinstance(t, ast.Subscript):
                return t.value
    elif isinstance(node, ast.AugAssign):
        if isinstance(node.target, ast.Subscript):
            return node.target.value
        return node.target
    elif (isinstance(node, ast.Call)
          and isinstance(node.func, ast.Attribute)
          and node.func.attr in _MUTATING_METHODS):
        return node.func.value
    elif isinstance(node, ast.Delete):
        for t in node.targets:
            if isinstance(t, ast.Subscript):
                return t.value
    return None


def _locally_bound_names(fn: ast.AST) -> Set[str]:
    """Names that are locals of `fn` per Python scoping: parameters plus
    plain-name binding targets (assign/annassign/for/with/walrus), minus
    anything declared `global`."""
    bound: Set[str] = set(
        a.arg for a in (fn.args.args + fn.args.kwonlyargs
                        + fn.args.posonlyargs))
    for extra in (fn.args.vararg, fn.args.kwarg):
        if extra is not None:
            bound.add(extra.arg)
    declared_global: Set[str] = set()
    for node in ast.walk(fn):
        targets = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, (ast.AnnAssign, ast.For, ast.NamedExpr)):
            targets = [node.target]
        elif isinstance(node, (ast.With, ast.AsyncWith)):
            targets = [i.optional_vars for i in node.items
                       if i.optional_vars is not None]
        elif isinstance(node, ast.Global):
            declared_global.update(node.names)
        for t in targets:
            # only NAME targets bind; a subscript/attribute store
            # (_cache[k] = v) mutates the existing object, it does not
            # rebind the name
            stack = [t]
            while stack:
                sub = stack.pop()
                if isinstance(sub, ast.Name):
                    bound.add(sub.id)
                elif isinstance(sub, (ast.Tuple, ast.List)):
                    stack.extend(sub.elts)
                elif isinstance(sub, ast.Starred):
                    stack.append(sub.value)
    return bound - declared_global


@register
class SharedMutableGlobal(Rule):
    name = "shared-mutable-global"
    severity = "error"
    description = (
        "module-level mutable container written from function scope "
        "without a lock in a concurrency-sensitive module (scheduler "
        "cycle/caches, store, koordlet, runtimeproxy): interleaved "
        "writers corrupt shared scheduler state")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        if not is_concurrent_path(ctx.path):
            return
        globals_: Set[str] = set()
        for stmt in ctx.tree.body:
            if isinstance(stmt, ast.Assign) and _is_mutable_literal(
                    stmt.value):
                for t in stmt.targets:
                    if isinstance(t, ast.Name):
                        globals_.add(t.id)
            elif (isinstance(stmt, ast.AnnAssign) and stmt.value is not None
                  and _is_mutable_literal(stmt.value)
                  and isinstance(stmt.target, ast.Name)):
                globals_.add(stmt.target.id)
        if not globals_:
            return
        for fn in ast.walk(ctx.tree):
            if not isinstance(fn, _FUNC_DEFS):
                continue
            # names shadowed by params/local assignment are locals, not
            # the module global — unless a `global` statement says so
            shadowed = _locally_bound_names(fn)
            for node in ast.walk(fn):
                target = _mutation_target(node)
                if target is None or not isinstance(target, ast.Name):
                    continue
                name = target.id
                if name not in globals_ or name in shadowed:
                    continue
                if _lock_held(ctx, node):
                    continue
                yield self.finding(
                    ctx, node,
                    f"module-level mutable {name!r} mutated in "
                    f"{fn.name!r} without holding a lock")


def _class_spawns_threads(cls: ast.ClassDef) -> bool:
    for node in ast.walk(cls):
        if isinstance(node, ast.Call):
            f = node.func
            tail = f.attr if isinstance(f, ast.Attribute) else (
                f.id if isinstance(f, ast.Name) else "")
            if tail in ("Thread", "Timer", "ThreadPoolExecutor"):
                return True
    return False


@register
class UnlockedSharedMutation(Rule):
    name = "unlocked-shared-mutation"
    severity = "warning"
    description = (
        "in a thread-spawning class (concurrency-sensitive modules only), "
        "a non-__init__ method mutates self.<container> outside a 'with "
        "<lock>' block: the spawned thread and its owner race on the "
        "attribute")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        if not is_concurrent_path(ctx.path):
            return
        for cls in ast.walk(ctx.tree):
            if not isinstance(cls, ast.ClassDef):
                continue
            if not _class_spawns_threads(cls):
                continue
            for fn in cls.body:
                if not isinstance(fn, _FUNC_DEFS):
                    continue
                if fn.name == "__init__" or fn.name.startswith("_init"):
                    continue  # construction happens-before thread spawn
                for node in ast.walk(fn):
                    target = _mutation_target(node)
                    if (target is None
                            or not isinstance(target, ast.Attribute)
                            or not isinstance(target.value, ast.Name)
                            or target.value.id != "self"):
                        continue
                    if _LOCKISH_RE.search(target.attr):
                        continue  # mutating the lock container itself
                    if _lock_held(ctx, node):
                        continue
                    yield self.finding(
                        ctx, node,
                        f"self.{target.attr} mutated in "
                        f"{cls.name}.{fn.name} outside a lock while the "
                        f"class spawns threads")


@register
class ExceptSwallow(Rule):
    name = "except-swallow"
    severity = "warning"
    description = (
        "bare 'except:' or an 'except Exception' handler whose entire "
        "body is pass/continue: swallows the loud failures (parity "
        "mismatches, exactness violations) the test strategy depends on")

    _BROAD = {"Exception", "BaseException"}

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if node.type is None:
                yield self.finding(
                    ctx, node,
                    "bare 'except:' catches KeyboardInterrupt/SystemExit "
                    "too; name the exception")
                continue
            names = set()
            types = (node.type.elts if isinstance(node.type, ast.Tuple)
                     else [node.type])
            for t in types:
                if isinstance(t, ast.Name):
                    names.add(t.id)
                elif isinstance(t, ast.Attribute):
                    names.add(t.attr)
            if not (names & self._BROAD):
                continue
            if all(isinstance(s, (ast.Pass, ast.Continue))
                   or (isinstance(s, ast.Expr)
                       and isinstance(s.value, ast.Constant))
                   for s in node.body):
                yield self.finding(
                    ctx, node,
                    "except Exception with an empty body silently "
                    "swallows every error; log or narrow it")


# the dispatch-critical packages where an unobserved swallow can mask the
# very failure signal the degradation ladder / flight recorder / sim
# fault plan are built around
_SWALLOW_GATED_RE = re.compile(r"(^|/)(scheduler|obs|parallel|sim)/")

_BROAD = {"Exception", "BaseException"}


def _is_broad_handler(node: ast.ExceptHandler) -> bool:
    if node.type is None:
        return True
    types = (node.type.elts if isinstance(node.type, ast.Tuple)
             else [node.type])
    for t in types:
        name = (t.id if isinstance(t, ast.Name)
                else t.attr if isinstance(t, ast.Attribute) else "")
        if name in _BROAD:
            return True
    return False


def _is_trivial_swallow_stmt(s: ast.stmt) -> bool:
    """pass / continue / a bare docstring-style constant / `return` of a
    constant or empty literal — shapes that discard the error without a
    trace. Anything else (a call, an assignment, a raise) counts as
    handling and is left to human review."""
    if isinstance(s, (ast.Pass, ast.Continue)):
        return True
    if isinstance(s, ast.Expr) and isinstance(s.value, ast.Constant):
        return True
    if isinstance(s, ast.Return):
        v = s.value
        if v is None or isinstance(v, ast.Constant):
            return True
        if isinstance(v, (ast.List, ast.Dict, ast.Tuple, ast.Set)):
            return not (getattr(v, "elts", None)
                        or getattr(v, "keys", None))
    return False


@register
class SilentExceptionSwallow(Rule):
    name = "silent-exception-swallow"
    severity = "error"
    description = (
        "in a dispatch-critical package (scheduler/, obs/, parallel/, "
        "sim/), a bare 'except:' / 'except Exception' whose whole body "
        "is pass/continue/return-constant — no raise, no log, no "
        "metric: the degradation ladder, flight recorder and sim fault "
        "plan all depend on failures being observable there; swallow "
        "deliberately only with a pragma explaining why")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        if not _SWALLOW_GATED_RE.search(ctx.path):
            return
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if not _is_broad_handler(node):
                continue
            if all(_is_trivial_swallow_stmt(s) for s in node.body):
                yield self.finding(
                    ctx, node,
                    "broad except handler discards the error without a "
                    "trace in a dispatch-critical path; log it, count "
                    "it, re-raise, or pragma the intent")
