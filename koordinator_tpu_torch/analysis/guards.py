"""koordrace guard analysis: the whole-program lock-discipline layer.

koordlint's per-function rules cannot see that a field guarded by
``_lock`` at nine call sites is touched bare at a tenth, or that two
code paths acquire the same two locks in opposite orders. This module
adds the missing program-level view, in three stages that stay inside
the plain-AST contract (no imports of the analyzed code, no jax):

1. **Fact extraction** (:func:`collect_module_facts`) — one pass per
   module producing a picklable :class:`ModuleFacts`: lock definitions
   (``self._lock = threading.Lock()`` and module-level ``_x = Lock()``),
   field touches (every ``self.<attr>`` read/write with the lexically
   held lock set), lock acquisitions, calls made while holding locks,
   guard annotations, and the declared canonical lock order. Picklable
   facts are what lets the CLI fan file parsing out to a worker pool
   while the whole-program passes still run once, in the parent.

2. **Guard-map inference** (:func:`build_guard_map`) — which attribute
   is protected by which lock. An explicit annotation on the
   field-defining assignment wins::

       self._ring = []  # koordlint: guarded-by(_lock)

   (``guarded-by(none)`` pins a field as deliberately unguarded).
   Unannotated fields are inferred by majority vote over their non-init
   touches: a field is guarded by lock L when at least
   ``_INFER_MIN_LOCKED`` touches happen under L and they form a strict
   majority of all touches. ``__init__``/``_init*`` bodies are excluded
   (construction happens-before any thread spawn, same stance as
   rules/concurrency.py).

3. **Lock graph + discipline checks** — consumed by
   ``analysis/rules/race.py``: per-touch guard violations, the
   inter-procedural acquisition graph (lexical nesting plus calls into
   methods whose transitive bodies acquire), cycle detection, the
   declared canonical order (``CANONICAL_LOCK_ORDER`` in
   ``obs/lockorder.py``, parsed from source — never imported), blocking
   calls under a lock, and the orphan-lock self-check behind
   ``python -m koordinator_tpu_torch.analysis --check-locks``.

Scope: the modules that genuinely face more than one thread — the
guard scan gates on :data:`GUARD_SCAN_RE` so import-time registries
elsewhere stay out of the map.
"""

from __future__ import annotations

import ast
import dataclasses
import re
from typing import Dict, Iterable, Iterator, List, Optional, Set, Tuple

# modules whose fields enter the guard map: the scheduler cycle driver
# and its caches, the observability rings, the balance/colo consumers,
# the event-sourced store, the sim harness (it spawns the racecheck
# threads), the metrics registry the canonical lock order ends at, and
# the kernel library cache (its first-build lock: the warm-up thread and
# the cycle may reach a kernel's first launch together)
GUARD_SCAN_RE = re.compile(
    r"((^|/)(scheduler|obs|balance|colo|sim)/"
    r"|(^|/)client/store\.py"
    r"|(^|/)koordlet/metrics\.py"
    r"|(^|/)ops/kernel_common\.py)")

# the single documented home of the declared lock order;
# the analyzer PARSES this module, it never imports it
CANONICAL_ORDER_MODULE_RE = re.compile(r"(^|/)obs/lockorder\.py$")
CANONICAL_ORDER_NAME = "CANONICAL_LOCK_ORDER"

GUARD_MAP_SCHEMA = "koordlint-guard-map"
GUARD_MAP_VERSION = 1

_GUARDED_BY_RE = re.compile(
    r"#\s*koordlint:\s*guarded-by\(\s*([A-Za-z_][A-Za-z0-9_]*|none)\s*\)")

# on a lock DEFINITION line: the lock protects a named external
# resource (a file, a subprocess, ...) rather than instance attributes,
# so the orphan-lock self-check must not flag it
_GUARDS_RE = re.compile(
    r"#\s*koordlint:\s*guards\(\s*([A-Za-z0-9_.\-/]+)\s*\)")

_LOCK_CTORS = {"Lock", "RLock"}

_FUNC_DEFS = (ast.FunctionDef, ast.AsyncFunctionDef)

MODULE_OWNER = "<module>"

# a field needs at least this many locked touches, forming a strict
# majority, before the guard is inferred (annotation overrides)
_INFER_MIN_LOCKED = 2


def is_guard_scanned_path(path: str) -> bool:
    return GUARD_SCAN_RE.search(path) is not None


# ---------------------------------------------------------------------------
# picklable per-module facts
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LockDef:
    """A lock-valued attribute: ``self.attr = threading.Lock()`` inside
    `owner`, or a module-level ``attr = Lock()`` (owner == MODULE_OWNER).
    ``alias_of`` names the module-level lock when the assignment re-binds
    one (``self._lock = _index_lock``) instead of constructing."""

    owner: str
    attr: str
    line: int
    kind: str                      # "Lock" | "RLock"
    alias_of: str = ""
    resource: str = ""             # from ``# koordlint: guards(x)``


@dataclasses.dataclass(frozen=True)
class Annotation:
    owner: str
    field: str
    guard: str                     # lock attr name, or "none"
    line: int


@dataclasses.dataclass(frozen=True)
class FieldTouch:
    owner: str
    field: str
    method: str
    line: int
    write: bool
    held: Tuple[str, ...]          # lock names lexically held at the touch
    in_init: bool


@dataclasses.dataclass(frozen=True)
class AcquireEvent:
    owner: str
    method: str
    lock: str
    line: int
    held: Tuple[str, ...]          # locks already held when acquiring


@dataclasses.dataclass(frozen=True)
class CallEvent:
    """A call made while inside a method: ``target`` is the dotted
    source head ("self._helper", "self.timeline.close", "time.sleep")."""

    owner: str
    method: str
    target: str
    line: int
    held: Tuple[str, ...]


@dataclasses.dataclass
class ModuleFacts:
    path: str
    locks: List[LockDef] = dataclasses.field(default_factory=list)
    annotations: List[Annotation] = dataclasses.field(default_factory=list)
    touches: List[FieldTouch] = dataclasses.field(default_factory=list)
    acquires: List[AcquireEvent] = dataclasses.field(default_factory=list)
    calls: List[CallEvent] = dataclasses.field(default_factory=list)
    # owner -> attr -> class name, from `self.x = ClassName(...)`
    attr_types: Dict[str, Dict[str, str]] = dataclasses.field(
        default_factory=dict)
    # class name -> method names (distinguishes self.m() calls from
    # self.field reads of stored callables)
    class_methods: Dict[str, Set[str]] = dataclasses.field(
        default_factory=dict)
    canonical_order: Tuple[str, ...] = ()


# ---------------------------------------------------------------------------
# extraction
# ---------------------------------------------------------------------------

def _call_name_tail(node: ast.Call) -> str:
    f = node.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return ""


def _dotted(expr: ast.AST) -> str:
    """'self.timeline.close' for the matching Attribute/Name chain,
    '' when the expression is not a plain dotted path."""
    parts: List[str] = []
    cur = expr
    while isinstance(cur, ast.Attribute):
        parts.append(cur.attr)
        cur = cur.value
    if isinstance(cur, ast.Name):
        parts.append(cur.id)
        return ".".join(reversed(parts))
    return ""


class _OwnerScanner:
    """Extracts facts for one owner: a class body or the module level."""

    def __init__(self, facts: ModuleFacts, owner: str,
                 lock_names: Set[str], module_locks: Set[str],
                 method_names: Set[str],
                 annotated_lines: Dict[int, str]) -> None:
        self.facts = facts
        self.owner = owner
        self.lock_names = lock_names          # this owner's lock attrs
        self.module_locks = module_locks      # module-level lock names
        self.method_names = method_names
        self.annotated_lines = annotated_lines

    def _held_at(self, parents: Dict[ast.AST, ast.AST],
                 node: ast.AST, fn: ast.AST) -> Tuple[str, ...]:
        """Lock names lexically held at `node` inside `fn`: every
        enclosing ``with self.<lock>`` / ``with <module-lock>``."""
        held: List[str] = []
        cur: Optional[ast.AST] = parents.get(node)
        while cur is not None and cur is not fn:
            if isinstance(cur, (ast.With, ast.AsyncWith)):
                for item in cur.items:
                    name = self._lock_expr_name(item.context_expr)
                    if name and name not in held:
                        held.append(name)
            cur = parents.get(cur)
        return tuple(held)

    def _lock_expr_name(self, expr: ast.AST) -> str:
        if isinstance(expr, ast.Attribute) and isinstance(
                expr.value, ast.Name) and expr.value.id == "self":
            if expr.attr in self.lock_names:
                return expr.attr
        elif isinstance(expr, ast.Name) and expr.id in self.module_locks:
            return expr.id
        return ""

    def scan_function(self, fn: ast.AST, parents: Dict[ast.AST, ast.AST],
                      in_init: bool) -> None:
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                self._scan_call(node, fn, parents)
            elif (isinstance(node, ast.Attribute)
                  and isinstance(node.value, ast.Name)
                  and node.value.id == "self"
                  and self.owner != MODULE_OWNER):
                self._scan_self_attr(node, fn, parents, in_init)

    def _scan_call(self, node: ast.Call, fn: ast.AST,
                   parents: Dict[ast.AST, ast.AST]) -> None:
        target = _dotted(node.func)
        if not target:
            return
        held = self._held_at(parents, node, fn)
        self.facts.calls.append(CallEvent(
            owner=self.owner, method=fn.name, target=target,
            line=node.lineno, held=held))

    def _record_acquires(self, fn: ast.AST,
                         parents: Dict[ast.AST, ast.AST]) -> None:
        for node in ast.walk(fn):
            if not isinstance(node, (ast.With, ast.AsyncWith)):
                continue
            for item in node.items:
                name = self._lock_expr_name(item.context_expr)
                if not name:
                    continue
                held = self._held_at(parents, node, fn)
                self.facts.acquires.append(AcquireEvent(
                    owner=self.owner, method=fn.name, lock=name,
                    line=node.lineno,
                    held=tuple(h for h in held if h != name)))

    def _scan_self_attr(self, node: ast.Attribute, fn: ast.AST,
                        parents: Dict[ast.AST, ast.AST],
                        in_init: bool) -> None:
        attr = node.attr
        if attr in self.lock_names:
            return  # the lock itself is not a guarded field
        parent = parents.get(node)
        # `self.method(...)` — a call on a defined method, not a field
        if (isinstance(parent, ast.Call) and parent.func is node
                and attr in self.method_names):
            return
        write = isinstance(node.ctx, (ast.Store, ast.Del))
        if not write and parent is not None:
            # `self.x[...] = v`, `self.x += v`, `self.x.append(v)` all
            # mutate through a Load of the attribute
            from koordinator_tpu_torch.analysis.rules.concurrency import (
                _mutation_target,
            )
            write = _mutation_target(parent) is node
        held = self._held_at(parents, node, fn)
        self.facts.touches.append(FieldTouch(
            owner=self.owner, field=attr, method=fn.name,
            line=node.lineno, write=write, held=held, in_init=in_init))
        if write and in_init:
            guard = self.annotated_lines.get(node.lineno)
            if guard:
                self.facts.annotations.append(Annotation(
                    owner=self.owner, field=attr, guard=guard,
                    line=node.lineno))



def _annotation_lines(source: str) -> Dict[int, str]:
    """line -> guard name for every ``# koordlint: guarded-by(x)``.
    A pragma alone on a line applies to the next line (mirrors the
    suppression comment convention in core.py)."""
    out: Dict[int, str] = {}
    for i, line in enumerate(source.splitlines(), start=1):
        m = _GUARDED_BY_RE.search(line)
        if not m:
            continue
        target = i + 1 if line.strip().startswith("#") else i
        out[target] = m.group(1)
    return out


def _resource_lines(source: str) -> Dict[int, str]:
    """line -> resource name for every ``# koordlint: guards(x)``; same
    next-line convention as :func:`_annotation_lines`."""
    out: Dict[int, str] = {}
    for i, line in enumerate(source.splitlines(), start=1):
        m = _GUARDS_RE.search(line)
        if not m:
            continue
        target = i + 1 if line.strip().startswith("#") else i
        out[target] = m.group(1)
    return out


def _module_level_locks(tree: ast.Module,
                        resources: Dict[int, str]) -> List[LockDef]:
    out: List[LockDef] = []
    for stmt in tree.body:
        if not isinstance(stmt, ast.Assign) or not isinstance(
                stmt.value, ast.Call):
            continue
        tail = _call_name_tail(stmt.value)
        if tail not in _LOCK_CTORS:
            continue
        for t in stmt.targets:
            if isinstance(t, ast.Name):
                out.append(LockDef(
                    owner=MODULE_OWNER, attr=t.id, line=stmt.lineno,
                    kind=tail,
                    resource=resources.get(stmt.lineno, "")))
    return out


def _module_level_fields(tree: ast.Module,
                         lock_names: Set[str]) -> Set[str]:
    """Module-level names that look like shared mutable state: assigned
    at top level (to anything) and re-bound or mutated from function
    scope. Import-time constants never re-touched stay out."""
    assigned: Set[str] = set()
    for stmt in tree.body:
        targets: List[ast.AST] = []
        if isinstance(stmt, ast.Assign):
            targets = list(stmt.targets)
        elif isinstance(stmt, ast.AnnAssign):
            targets = [stmt.target]
        for t in targets:
            if isinstance(t, ast.Name) and t.id not in lock_names:
                assigned.add(t.id)
    return assigned


def _class_lock_defs(cls: ast.ClassDef, module_locks: Set[str],
                     resources: Dict[int, str]) -> List[LockDef]:
    out: List[LockDef] = []
    for fn in cls.body:
        if not isinstance(fn, _FUNC_DEFS):
            continue
        for node in ast.walk(fn):
            if not isinstance(node, ast.Assign):
                continue
            for t in node.targets:
                if not (isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"):
                    continue
                if isinstance(node.value, ast.Call):
                    tail = _call_name_tail(node.value)
                    if tail in _LOCK_CTORS:
                        out.append(LockDef(
                            owner=cls.name, attr=t.attr,
                            line=node.lineno, kind=tail,
                            resource=resources.get(node.lineno, "")))
                elif (isinstance(node.value, ast.Name)
                      and node.value.id in module_locks):
                    out.append(LockDef(
                        owner=cls.name, attr=t.attr, line=node.lineno,
                        kind="Lock", alias_of=node.value.id,
                        resource=resources.get(node.lineno, "")))
    return out


def _parse_canonical_order(tree: ast.Module) -> Tuple[str, ...]:
    for stmt in tree.body:
        targets: List[ast.AST] = []
        value: Optional[ast.AST] = None
        if isinstance(stmt, ast.Assign):
            targets, value = list(stmt.targets), stmt.value
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            targets, value = [stmt.target], stmt.value
        if not any(isinstance(t, ast.Name)
                   and t.id == CANONICAL_ORDER_NAME for t in targets):
            continue
        if isinstance(value, (ast.Tuple, ast.List)):
            out = []
            for e in value.elts:
                if isinstance(e, ast.Constant) and isinstance(e.value, str):
                    out.append(e.value)
            return tuple(out)
    return ()


def collect_module_facts(path: str, source: str,
                         tree: ast.Module) -> Optional[ModuleFacts]:
    """One module's concurrency facts, or None when the path is outside
    the guard scan set (and declares no canonical order)."""
    path = path.replace("\\", "/")
    canonical = (_parse_canonical_order(tree)
                 if CANONICAL_ORDER_MODULE_RE.search(path) else ())
    if not is_guard_scanned_path(path) and not canonical:
        return None
    facts = ModuleFacts(path=path, canonical_order=canonical)
    annotated = _annotation_lines(source)
    resources = _resource_lines(source)
    mod_locks = _module_level_locks(tree, resources)
    facts.locks.extend(mod_locks)
    module_lock_names = {d.attr for d in mod_locks}

    parents: Dict[ast.AST, ast.AST] = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            parents[child] = node

    classes = [n for n in ast.walk(tree) if isinstance(n, ast.ClassDef)]
    for cls in classes:
        methods = {f.name for f in cls.body if isinstance(f, _FUNC_DEFS)}
        facts.class_methods[cls.name] = methods
        lock_defs = _class_lock_defs(cls, module_lock_names, resources)
        facts.locks.extend(lock_defs)
        lock_names = {d.attr for d in lock_defs}
        scanner = _OwnerScanner(facts, cls.name, lock_names,
                                module_lock_names, methods, annotated)
        attr_types: Dict[str, str] = {}
        for fn in cls.body:
            if not isinstance(fn, _FUNC_DEFS):
                continue
            in_init = fn.name == "__init__" or fn.name.startswith("_init")
            scanner.scan_function(fn, parents, in_init)
            scanner._record_acquires(fn, parents)
            if in_init:
                for node in ast.walk(fn):
                    if not isinstance(node, ast.Assign) or not isinstance(
                            node.value, ast.Call):
                        continue
                    tail = _call_name_tail(node.value)
                    if not tail or tail in _LOCK_CTORS:
                        continue
                    for t in node.targets:
                        if (isinstance(t, ast.Attribute)
                                and isinstance(t.value, ast.Name)
                                and t.value.id == "self"
                                and tail[:1].isupper()):
                            attr_types[t.attr] = tail
        if attr_types:
            facts.attr_types[cls.name] = attr_types

    # module-level functions: track touches of module-level shared names
    module_fields = _module_level_fields(tree, module_lock_names)
    _collect_module_scope(facts, tree, parents, module_fields,
                          module_lock_names, annotated)
    return facts


def _collect_module_scope(facts: ModuleFacts, tree: ast.Module,
                          parents: Dict[ast.AST, ast.AST],
                          module_fields: Set[str],
                          module_lock_names: Set[str],
                          annotated: Dict[int, str]) -> None:
    """Touches/acquires/calls of module-scope state inside module-level
    (and method) function bodies. Methods count too: warmup.py mutates
    module-level ladder state from WarmupRunner methods."""
    from koordinator_tpu_torch.analysis.rules.concurrency import (
        _locally_bound_names,
        _mutation_target,
    )
    scanner = _OwnerScanner(facts, MODULE_OWNER, set(),
                            module_lock_names, set(), annotated)
    # annotation on the module-level defining assignment
    for stmt in tree.body:
        targets: List[ast.AST] = []
        if isinstance(stmt, ast.Assign):
            targets = list(stmt.targets)
        elif isinstance(stmt, ast.AnnAssign):
            targets = [stmt.target]
        guard = annotated.get(stmt.lineno) if targets else None
        if guard:
            for t in targets:
                if isinstance(t, ast.Name) and t.id in module_fields:
                    facts.annotations.append(Annotation(
                        owner=MODULE_OWNER, field=t.id, guard=guard,
                        line=stmt.lineno))
    for fn in ast.walk(tree):
        if not isinstance(fn, _FUNC_DEFS):
            continue
        in_method = _enclosing_class(fn, parents) is not None
        local = _locally_bound_names(fn)
        declared_global: Set[str] = set()
        for node in ast.walk(fn):
            if isinstance(node, ast.Global):
                declared_global.update(node.names)
        if not in_method:
            # methods already contributed acquires/calls under their
            # class owner; re-recording them here would double-count
            # graph edges under a bogus module owner
            scanner._record_acquires(fn, parents)
            for node in ast.walk(fn):
                if isinstance(node, ast.Call):
                    scanner._scan_call(node, fn, parents)
        for node in ast.walk(fn):
            if not isinstance(node, ast.Name):
                continue
            name = node.id
            if name not in module_fields or name in module_lock_names:
                continue
            if name in local and name not in declared_global:
                continue
            write = isinstance(node.ctx, (ast.Store, ast.Del))
            parent = parents.get(node)
            if not write and parent is not None:
                write = _mutation_target(parent) is node
            if not write and isinstance(parent, ast.Attribute):
                gp = parents.get(parent)
                if gp is not None and _mutation_target(gp) is parent:
                    # `_cache.pop(...)` resolves _mutation_target to the
                    # Attribute `_cache.pop`'s value — already handled —
                    # but `_live_threads.remove(t)` shapes land here
                    write = True
            held = scanner._held_at(parents, node, fn)
            facts.touches.append(FieldTouch(
                owner=MODULE_OWNER, field=name, method=fn.name,
                line=node.lineno, write=write, held=held,
                in_init=False))


# ---------------------------------------------------------------------------
# guard map
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class GuardedField:
    owner: str
    field: str
    guard: Optional[str]           # None == explicitly/effectively bare
    source: str                    # "annotation" | "inferred" | "unguarded"
    reads: int = 0
    writes: int = 0
    bare: int = 0                  # non-init touches without the guard


@dataclasses.dataclass
class ModuleGuards:
    path: str
    locks: List[LockDef]
    fields: List[GuardedField]


class GuardMap:
    """The program-wide guard map plus the raw facts it was built from."""

    def __init__(self, facts_list: List[ModuleFacts]) -> None:
        self.facts_list = facts_list
        self.modules: Dict[str, ModuleGuards] = {}
        # (path, owner, field) -> GuardedField
        self.fields: Dict[Tuple[str, str, str], GuardedField] = {}
        self.canonical_order: Tuple[str, ...] = ()
        for facts in facts_list:
            if facts.canonical_order:
                self.canonical_order = facts.canonical_order
            self._build_module(facts)

    def _build_module(self, facts: ModuleFacts) -> None:
        lock_by_owner: Dict[str, Set[str]] = {}
        for d in facts.locks:
            lock_by_owner.setdefault(d.owner, set()).add(d.attr)
        ann: Dict[Tuple[str, str], Annotation] = {
            (a.owner, a.field): a for a in facts.annotations}
        by_field: Dict[Tuple[str, str], List[FieldTouch]] = {}
        for t in facts.touches:
            by_field.setdefault((t.owner, t.field), []).append(t)
        out: List[GuardedField] = []
        for (owner, field), touches in sorted(by_field.items()):
            own_locks = lock_by_owner.get(owner, set()) | \
                lock_by_owner.get(MODULE_OWNER, set())
            live = [t for t in touches if not t.in_init]
            a = ann.get((owner, field))
            if a is not None:
                guard = None if a.guard == "none" else a.guard
                source = "annotation"
            else:
                guard, source = self._infer(live, own_locks)
            gf = GuardedField(owner=owner, field=field, guard=guard,
                             source=source)
            for t in live:
                if t.write:
                    gf.writes += 1
                else:
                    gf.reads += 1
                if guard is not None and guard not in t.held:
                    gf.bare += 1
            out.append(gf)
            self.fields[(facts.path, owner, field)] = gf
        self.modules[facts.path] = ModuleGuards(
            path=facts.path, locks=sorted(
                facts.locks, key=lambda d: (d.owner, d.attr)),
            fields=out)

    @staticmethod
    def _infer(touches: List[FieldTouch],
               own_locks: Set[str]) -> Tuple[Optional[str], str]:
        if not touches:
            return None, "unguarded"
        counts: Dict[str, int] = {}
        for t in touches:
            for h in t.held:
                if h in own_locks:
                    counts[h] = counts.get(h, 0) + 1
        if not counts:
            return None, "unguarded"
        guard, n = max(counts.items(), key=lambda kv: (kv[1], kv[0]))
        if n >= _INFER_MIN_LOCKED and n > len(touches) - n:
            return guard, "inferred"
        return None, "unguarded"

    # -- queries ------------------------------------------------------

    def guard_for(self, path: str, owner: str,
                  field: str) -> Optional[GuardedField]:
        return self.fields.get((path, owner, field))

    def guarded_touchpoints(self) -> Iterator[Tuple[ModuleFacts,
                                                    FieldTouch,
                                                    GuardedField]]:
        """Every non-init touch of a guarded field, with its guard."""
        for facts in self.facts_list:
            for t in facts.touches:
                if t.in_init:
                    continue
                gf = self.fields.get((facts.path, t.owner, t.field))
                if gf is not None and gf.guard is not None:
                    yield facts, t, gf

    def orphan_locks(self) -> List[Tuple[str, LockDef]]:
        """(path, lock) pairs for locks that guard nothing: neither
        annotated as a guard nor inferred for any field. Every shipped
        lock must earn its place in the map (or the map is lying about
        coverage)."""
        guards_in_use: Dict[str, Set[str]] = {}
        for (path, owner, _field), gf in self.fields.items():
            if gf.guard is not None:
                guards_in_use.setdefault(path, set()).add(gf.guard)
        out = []
        for facts in self.facts_list:
            used = guards_in_use.get(facts.path, set())
            aliased = {d.alias_of for d in facts.locks if d.alias_of}
            resourced = {d.attr for d in facts.locks if d.resource}
            for d in facts.locks:
                if d.resource:  # declares an external resource
                    continue
                if d.attr in used or d.attr in aliased:
                    continue
                # an alias points at a module lock: the alias earns its
                # keep when the aliased name guards something (and vice
                # versa — `self._lock = _index_lock` counts for both),
                # including a declared external resource
                if d.alias_of and (d.alias_of in used
                                   or d.alias_of in resourced):
                    continue
                out.append((facts.path, d))
        return sorted(out, key=lambda pd: (pd[0], pd[1].owner, pd[1].attr))

    def to_dict(self) -> Dict[str, object]:
        modules = []
        for path in sorted(self.modules):
            mg = self.modules[path]
            owners: Dict[str, Dict[str, object]] = {}
            for d in mg.locks:
                o = owners.setdefault(d.owner, {"owner": d.owner,
                                                "locks": [], "fields": []})
                o["locks"].append({
                    "attr": d.attr, "line": d.line, "kind": d.kind,
                    **({"alias_of": d.alias_of} if d.alias_of else {}),
                    **({"resource": d.resource} if d.resource else {})})
            for gf in mg.fields:
                o = owners.setdefault(gf.owner, {"owner": gf.owner,
                                                 "locks": [], "fields": []})
                o["fields"].append({
                    "name": gf.field, "guard": gf.guard,
                    "source": gf.source, "reads": gf.reads,
                    "writes": gf.writes, "bare": gf.bare})
            modules.append({
                "path": path,
                "owners": [owners[k] for k in sorted(owners)],
            })
        return {
            "schema": GUARD_MAP_SCHEMA,
            "version": GUARD_MAP_VERSION,
            "canonical_lock_order": list(self.canonical_order),
            "modules": modules,
        }


# ---------------------------------------------------------------------------
# inter-procedural lock graph
# ---------------------------------------------------------------------------

def _enclosing_class(fn: ast.AST,
                     parents: Dict[ast.AST, ast.AST]) -> Optional[str]:
    cur = parents.get(fn)
    while cur is not None:
        if isinstance(cur, ast.ClassDef):
            return cur.name
        cur = parents.get(cur)
    return None


def lock_key(path: str, owner: str, attr: str) -> str:
    if owner == MODULE_OWNER:
        return f"{path}::{attr}"
    return f"{owner}.{attr}"


def _resolve_lock_key(facts: ModuleFacts, owner: str, name: str) -> str:
    """A method saying ``with _ladder_lock:`` holds the MODULE's lock,
    not a class attribute — key it where the lock is defined."""
    for d in facts.locks:
        if d.owner == owner and d.attr == name:
            return lock_key(facts.path, owner, name)
    for d in facts.locks:
        if d.owner == MODULE_OWNER and d.attr == name:
            return lock_key(facts.path, MODULE_OWNER, name)
    return lock_key(facts.path, owner, name)


@dataclasses.dataclass(frozen=True)
class LockEdge:
    src: str                       # lock key held
    dst: str                       # lock key acquired under it
    path: str
    line: int
    via: str                       # "nested-with" | "call:<target>"


class LockGraph:
    """Acquisition-order edges: src held while dst acquired. Lexical
    nesting contributes direct edges; calls into methods of known
    classes contribute one level of inter-procedural edges through the
    callee's transitive (intra-class) acquisition closure."""

    def __init__(self, guard_map: GuardMap) -> None:
        self.guard_map = guard_map
        self.edges: List[LockEdge] = []
        self._build()

    def _build(self) -> None:
        facts_list = self.guard_map.facts_list
        # class name -> method -> resolved lock keys its body (or a
        # same-class callee) acquires
        closures: Dict[str, Dict[str, Set[str]]] = {}
        for facts in facts_list:
            for cls, methods in facts.class_methods.items():
                closures[cls] = _method_lock_closure(facts, cls, methods)
        for facts in facts_list:
            for ev in facts.acquires:
                dst = _resolve_lock_key(facts, ev.owner, ev.lock)
                for h in ev.held:
                    self.edges.append(LockEdge(
                        src=_resolve_lock_key(facts, ev.owner, h), dst=dst,
                        path=facts.path, line=ev.line, via="nested-with"))
            for call in facts.calls:
                if not call.held:
                    continue
                callee = _resolve_call(facts, call)
                if callee is None:
                    continue
                cls, method = callee
                locks = closures.get(cls, {}).get(method, set())
                for dst in sorted(locks):
                    for h in call.held:
                        src = _resolve_lock_key(facts, call.owner, h)
                        if src != dst:
                            self.edges.append(LockEdge(
                                src=src, dst=dst, path=facts.path,
                                line=call.line,
                                via=f"call:{call.target}"))

    def cycles(self) -> List[Tuple[Tuple[str, ...], LockEdge]]:
        """Distinct lock-order cycles as (canonical key tuple, witness
        edge). Reported once per cycle, anchored at its first edge."""
        adj: Dict[str, List[LockEdge]] = {}
        for e in self.edges:
            adj.setdefault(e.src, []).append(e)
        seen: Set[Tuple[str, ...]] = set()
        out: List[Tuple[Tuple[str, ...], LockEdge]] = []
        for start in sorted(adj):
            stack: List[Tuple[str, Tuple[str, ...], Optional[LockEdge]]] = [
                (start, (start,), None)]
            while stack:
                node, trail, first = stack.pop()
                for e in adj.get(node, ()):  # noqa: B023
                    w = first or e
                    if e.dst == start:
                        cyc = trail
                        # canonical rotation so A->B->A and B->A->B dedup
                        i = cyc.index(min(cyc))
                        key = cyc[i:] + cyc[:i]
                        if key not in seen:
                            seen.add(key)
                            out.append((key, w))
                    elif e.dst not in trail and len(trail) < 6:
                        stack.append((e.dst, trail + (e.dst,), w))
        return out

    def declared_violations(self) -> List[LockEdge]:
        order = self.guard_map.canonical_order
        if not order:
            return []
        idx = {name: i for i, name in enumerate(order)}
        out = []
        for e in self.edges:
            si, di = idx.get(e.src), idx.get(e.dst)
            if si is not None and di is not None and si > di:
                out.append(e)
        return out


def _method_lock_closure(facts: ModuleFacts, cls: str,
                         methods: Set[str]) -> Dict[str, Set[str]]:
    """method -> resolved lock keys acquired in its body or
    (transitively) in same-class methods it calls."""
    direct: Dict[str, Set[str]] = {m: set() for m in methods}
    calls: Dict[str, Set[str]] = {m: set() for m in methods}
    for ev in facts.acquires:
        if ev.owner == cls and ev.method in direct:
            direct[ev.method].add(_resolve_lock_key(facts, cls, ev.lock))
    for call in facts.calls:
        if call.owner != cls or call.method not in calls:
            continue
        parts = call.target.split(".")
        if len(parts) == 2 and parts[0] == "self" and parts[1] in methods:
            calls[call.method].add(parts[1])
    closure = {m: set(v) for m, v in direct.items()}
    changed = True
    while changed:
        changed = False
        for m in methods:
            for callee in calls[m]:
                before = len(closure[m])
                closure[m] |= closure[callee]
                changed = changed or len(closure[m]) != before
    return closure


def _resolve_call(facts: ModuleFacts,
                  call: CallEvent) -> Optional[Tuple[str, str]]:
    """'self.timeline.close' -> ('DeviceTimeline', 'close') via the
    owner's attr-type map; 'self._helper' -> (owner, '_helper')."""
    parts = call.target.split(".")
    if parts[0] != "self":
        return None
    if len(parts) == 2:
        if parts[1] in facts.class_methods.get(call.owner, set()):
            return call.owner, parts[1]
        return None
    if len(parts) == 3:
        cls = facts.attr_types.get(call.owner, {}).get(parts[1])
        if cls is not None:
            return cls, parts[2]
    return None


# ---------------------------------------------------------------------------
# inter-procedural held-lock propagation (for the field rule)
# ---------------------------------------------------------------------------

def caller_held_locks(facts: ModuleFacts) -> Dict[Tuple[str, str],
                                                  Set[str]]:
    """(owner, method) -> locks provably held by EVERY caller. Only
    private methods (leading underscore) qualify — a public method is
    an external entry point and can always be entered bare. Standard
    narrowing dataflow: start private methods with >=1 same-class call
    site at the full lock set, intersect over call sites to fixpoint."""
    module_locks = {d.attr for d in facts.locks
                    if d.owner == MODULE_OWNER}
    all_locks: Dict[str, Set[str]] = {}
    for d in facts.locks:
        all_locks.setdefault(d.owner, set(module_locks)).add(d.attr)
    sites: Dict[Tuple[str, str], List[CallEvent]] = {}
    for call in facts.calls:
        parts = call.target.split(".")
        if (len(parts) == 2 and parts[0] == "self"
                and parts[1] in facts.class_methods.get(call.owner, set())):
            sites.setdefault((call.owner, parts[1]), []).append(call)
    held: Dict[Tuple[str, str], Set[str]] = {}
    for key, call_list in sites.items():
        owner, method = key
        if method.startswith("_") and not method.startswith("__"):
            held[key] = set(all_locks.get(owner, set()))
    for _ in range(len(held) + 1):
        changed = False
        for key, call_list in sites.items():
            if key not in held:
                continue
            acc: Optional[Set[str]] = None
            for c in call_list:
                h = set(c.held) | held.get((c.owner, c.method), set())
                acc = h if acc is None else (acc & h)
            acc = acc or set()
            if acc != held[key]:
                held[key] = acc
                changed = True
        if not changed:
            break
    return held


# ---------------------------------------------------------------------------
# program-level entry points (used by the CLI and racecheck)
# ---------------------------------------------------------------------------

def collect_facts_for_paths(paths: Iterable[str]) -> List[ModuleFacts]:
    """Parse + extract facts for every python file under `paths` (no
    rules, no baseline — the guard-map dump path)."""
    from koordinator_tpu_torch.analysis.core import (
        _canonical_path,
        iter_python_files,
    )
    out: List[ModuleFacts] = []
    for f in iter_python_files(paths):
        try:
            source = f.read_text()
            tree = ast.parse(source)
        except (OSError, SyntaxError):
            continue
        facts = collect_module_facts(_canonical_path(f), source, tree)
        if facts is not None:
            out.append(facts)
    return out


def build_guard_map(facts_list: List[ModuleFacts]) -> GuardMap:
    return GuardMap(facts_list)
