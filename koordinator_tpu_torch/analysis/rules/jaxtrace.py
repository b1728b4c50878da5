"""JAX-tracing hygiene rules.

The rebuild's hot path is batched pod x node math under ``jax.jit`` /
``pallas_call``; code inside those traces must not synchronize with the
host (``.item()``, ``np.asarray``, ``print``), must not branch in Python
on traced values (silent recompilation per shape/value, or a flat
TracerBoolConversionError at scale), and must pin dtypes on array
constructors (implicit float64 under x64 doubles HBM traffic and breaks
the kernels' f32-exactness discipline).

Traced-function discovery is lexical and per-module:

  1. defs decorated with jit/pjit/vmap/checkpoint/remat (bare, dotted, or
     wrapped in functools.partial(jax.jit, ...));
  2. local defs whose NAME is passed to a tracing entry point —
     ``jax.jit(step)``, ``pl.pallas_call(kernel, ...)``,
     ``jax.lax.scan/fori_loop/while_loop/cond``, ``jax.vmap`` — anywhere
     in the module (this repo's dominant idiom: build_x_step defines
     ``step`` then returns ``jax.jit(step)``);
  3. the transitive closure over local calls: a helper invoked from a
     traced body is itself traced.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Set

from koordinator_tpu_torch.analysis.core import (
    Finding,
    ModuleContext,
    Rule,
    register,
)

# call targets whose function-typed arguments become traced
_TRACING_ENTRY_TAILS = {
    "jit", "pjit", "vmap", "pmap", "pallas_call", "scan", "fori_loop",
    "while_loop", "cond", "checkpoint", "remat", "shard_map", "grad",
    "value_and_grad", "custom_vjp", "custom_jvp", "named_call",
}

_TRACE_DECORATOR_TAILS = {
    "jit", "pjit", "vmap", "pmap", "checkpoint", "remat", "custom_vjp",
    "custom_jvp",
}

_FUNC_DEFS = (ast.FunctionDef, ast.AsyncFunctionDef)


def _dotted_tail(node: ast.AST) -> str:
    """Last attribute segment of a Name/Attribute chain ('' otherwise)."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return ""


def _is_tracing_call(call: ast.Call) -> bool:
    tail = _dotted_tail(call.func)
    if tail in _TRACING_ENTRY_TAILS:
        return True
    # functools.partial(jax.jit, ...) as decorator/wrapper
    if tail == "partial" and call.args:
        return _dotted_tail(call.args[0]) in _TRACING_ENTRY_TAILS
    return False


def find_traced_functions(tree: ast.Module) -> Set[ast.AST]:
    defs_by_name: Dict[str, List[ast.AST]] = {}
    for node in ast.walk(tree):
        if isinstance(node, _FUNC_DEFS):
            defs_by_name.setdefault(node.name, []).append(node)

    traced: Set[ast.AST] = set()

    for node in ast.walk(tree):
        if isinstance(node, _FUNC_DEFS):
            for dec in node.decorator_list:
                tail = _dotted_tail(dec)
                if tail in _TRACE_DECORATOR_TAILS:
                    traced.add(node)
                elif isinstance(dec, ast.Call) and _is_tracing_call(dec):
                    traced.add(node)
        elif isinstance(node, ast.Call) and _is_tracing_call(node):
            for arg in list(node.args) + [kw.value for kw in node.keywords]:
                if isinstance(arg, ast.Name):
                    for d in defs_by_name.get(arg.id, []):
                        traced.add(d)
                elif isinstance(arg, ast.Lambda):
                    traced.add(arg)

    # transitive closure over same-module calls from traced bodies
    changed = True
    while changed:
        changed = False
        for fn in list(traced):
            body = fn.body if isinstance(fn, _FUNC_DEFS) else [fn.body]
            for node in ast.walk(ast.Module(body=list(body),
                                            type_ignores=[])):
                if isinstance(node, ast.Call):
                    name = (node.func.id
                            if isinstance(node.func, ast.Name) else "")
                    for d in defs_by_name.get(name, []):
                        if d not in traced:
                            traced.add(d)
                            changed = True
    return traced


def _body_nodes(fn: ast.AST, skip: Set[ast.AST] = frozenset()
                ) -> Iterator[ast.AST]:
    """Walk a traced callable's body (lambda bodies included), without
    descending into nested defs in `skip` — they are traced functions in
    their own right and report their own findings once."""
    roots = (list(fn.body) if isinstance(fn, _FUNC_DEFS)
             else [fn.body] if isinstance(fn, ast.Lambda) else [])
    stack = list(roots)
    while stack:
        node = stack.pop()
        if node in skip:
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _contains_shape_or_len(node: ast.AST) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Attribute) and sub.attr in (
                "shape", "ndim", "size", "dtype"):
            return True
        if (isinstance(sub, ast.Call) and isinstance(sub.func, ast.Name)
                and sub.func.id == "len"):
            return True
    return False


def _under_isinstance_guard(ctx: ModuleContext, node: ast.AST) -> bool:
    """Is `node` inside an if/elif whose test calls isinstance()? Such
    branches are runtime-type dispatch (e.g. 'not a Tracer' fast paths)
    where host materialization is deliberate."""
    parents = ctx.parent_map()
    cur = parents.get(node)
    while cur is not None:
        if isinstance(cur, (ast.If, ast.IfExp)):
            for sub in ast.walk(cur.test):
                if (isinstance(sub, ast.Call)
                        and isinstance(sub.func, ast.Name)
                        and sub.func.id == "isinstance"):
                    return True
        cur = parents.get(cur)
    return False


@register
class HostSyncInTrace(Rule):
    name = "jax-host-sync"
    severity = "error"
    description = (
        "host synchronization inside a jit/pallas-traced function: "
        ".item()/.tolist()/np.asarray/float()/int() forces a device->host "
        "readback (or fails outright on tracers), serializing the batched "
        "Filter/Score pipeline")

    _SYNC_METHODS = {"item", "tolist", "block_until_ready"}
    _HOST_NUMPY = {"asarray", "array"}
    _CASTS = {"float", "int", "bool"}

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        traced = ctx.traced_functions()
        for fn in traced:
            jnp_names = _jnp_derived_names(fn, traced)
            for node in _body_nodes(fn, skip=traced):
                if not isinstance(node, ast.Call):
                    continue
                func = node.func
                if (isinstance(func, ast.Attribute)
                        and func.attr in self._SYNC_METHODS
                        and not node.args):
                    yield self.finding(
                        ctx, node,
                        f".{func.attr}() inside traced function "
                        f"{_fn_name(fn)!r} forces a host sync")
                elif (isinstance(func, ast.Attribute)
                      and isinstance(func.value, ast.Name)
                      and func.value.id in ("np", "numpy")
                      and func.attr in self._HOST_NUMPY
                      and not _under_isinstance_guard(ctx, node)):
                    yield self.finding(
                        ctx, node,
                        f"np.{func.attr}() inside traced function "
                        f"{_fn_name(fn)!r} materializes on host; use jnp")
                elif (isinstance(func, ast.Name)
                      and func.id in self._CASTS and len(node.args) == 1
                      # only values that flowed through jnp/lax ops are
                      # (likely) tracers; float() on static Python config
                      # is trace-time metaprogramming and legal
                      and _expr_is_jnp(node.args[0], jnp_names)
                      and not _contains_shape_or_len(node.args[0])
                      and not _under_isinstance_guard(ctx, node)):
                    yield self.finding(
                        ctx, node,
                        f"{func.id}() on a jnp-derived value inside traced "
                        f"function {_fn_name(fn)!r} concretizes the tracer")


@register
class TracedValueBranch(Rule):
    name = "jax-traced-branch"
    severity = "error"
    description = (
        "Python if/while/assert on a value produced by jnp ops inside a "
        "traced function: bool() on a tracer raises (or triggers "
        "per-value recompilation under static args); use jnp.where / "
        "lax.cond")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        traced = ctx.traced_functions()
        for fn in traced:
            jnp_names = _jnp_derived_names(fn, traced)
            for node in _body_nodes(fn, skip=traced):
                test = None
                if isinstance(node, (ast.If, ast.While, ast.Assert,
                                     ast.IfExp)):
                    test = node.test
                if test is None:
                    continue
                if _expr_is_jnp(test, jnp_names):
                    yield self.finding(
                        ctx, node,
                        f"Python branch on jnp-derived value inside traced "
                        f"function {_fn_name(fn)!r}; use jnp.where or "
                        f"lax.cond")


def _jnp_derived_names(fn: ast.AST, traced: Set[ast.AST]) -> Set[str]:
    """Names assigned (directly or through arithmetic) from jnp.*/lax.*
    calls within the function body. A subscripted store taints only the
    container, never the index (numa[k] = jnp... must not taint k)."""
    derived: Set[str] = set()
    changed = True
    while changed:
        changed = False
        for node in _body_nodes(fn, skip=traced):
            if not isinstance(node, (ast.Assign, ast.AugAssign)):
                continue
            if not _expr_is_jnp(node.value, derived):
                continue
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                while isinstance(t, (ast.Subscript, ast.Starred,
                                     ast.Attribute)):
                    t = t.value
                names = ([t] if isinstance(t, ast.Name)
                         else [e for e in getattr(t, "elts", [])
                               if isinstance(e, ast.Name)])
                for n in names:
                    if n.id not in derived:
                        derived.add(n.id)
                        changed = True
    return derived


def _expr_is_jnp(node: ast.AST, derived: Set[str]) -> bool:
    """Does this expression produce a (likely) traced array — a jnp.* /
    lax.* call or arithmetic over names already known to?"""
    if isinstance(node, ast.Call):
        f = node.func
        while isinstance(f, ast.Attribute):
            if isinstance(f.value, ast.Name) and f.value.id in (
                    "jnp", "lax"):
                return True
            f = f.value
        return False
    if isinstance(node, ast.BinOp):
        return (_expr_is_jnp(node.left, derived)
                or _expr_is_jnp(node.right, derived))
    if isinstance(node, ast.UnaryOp):
        return _expr_is_jnp(node.operand, derived)
    if isinstance(node, ast.Compare):
        return any(_expr_is_jnp(c, derived)
                   for c in [node.left] + node.comparators)
    if isinstance(node, (ast.Subscript, ast.Attribute)):
        return _expr_is_jnp(node.value, derived)
    if isinstance(node, ast.Name):
        return node.id in derived
    return False


def _fn_name(fn: ast.AST) -> str:
    return getattr(fn, "name", "<lambda>")


@register
class ImplicitDtype(Rule):
    name = "jax-implicit-dtype"
    severity = "warning"
    description = (
        "jnp array constructor without an explicit dtype=: the result "
        "dtype then depends on jax_enable_x64 / weak-type promotion, and "
        "an accidental float64 doubles HBM traffic and breaks f32 "
        "exactness parity with the serial floor")

    _CONSTRUCTORS = {"zeros", "ones", "full", "empty", "arange",
                     "linspace", "eye"}

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            if not (isinstance(func, ast.Attribute)
                    and isinstance(func.value, ast.Name)
                    and func.value.id == "jnp"
                    and func.attr in self._CONSTRUCTORS):
                continue
            if any(kw.arg == "dtype" for kw in node.keywords):
                continue
            # positional dtype: zeros(shape, dtype) / full(shape, v, dtype)
            npos = {"zeros": 2, "ones": 2, "empty": 2, "eye": 2,
                    "full": 3, "arange": 4, "linspace": 7}
            if len(node.args) >= npos.get(func.attr, 99):
                continue
            yield self.finding(
                ctx, node,
                f"jnp.{func.attr}() without dtype=; pin the dtype "
                f"(implicit float64 drift)")


@register
class JitInLoop(Rule):
    name = "jax-jit-in-loop"
    severity = "warning"
    description = (
        "jax.jit/pallas_call invoked inside a Python loop: every "
        "iteration builds and compiles a fresh program (cache keyed on "
        "function identity), turning a hot loop into a recompilation "
        "storm; hoist the jit out or cache the compiled callable")

    _TAILS = {"jit", "pjit", "pallas_call"}

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        loops: List[ast.AST] = [
            n for n in ast.walk(ctx.tree)
            if isinstance(n, (ast.For, ast.While))
        ]
        for loop in loops:
            for node in ast.walk(loop):
                if node is loop:
                    continue
                if (isinstance(node, ast.Call)
                        and _dotted_tail(node.func) in self._TAILS
                        # a def inside the loop is only a definition;
                        # flag direct calls in the loop body
                        and not _inside_def(loop, node)):
                    yield self.finding(
                        ctx, node,
                        f"{_dotted_tail(node.func)}() inside a loop "
                        f"recompiles every iteration; hoist or memoize")


def _inside_def(loop: ast.AST, node: ast.AST) -> bool:
    """Is `node` under a function definition nested inside `loop`?"""
    for sub in ast.walk(loop):
        if isinstance(sub, _FUNC_DEFS) and sub is not loop:
            for inner in ast.walk(sub):
                if inner is node:
                    return True
    return False


@register
class PrintInTrace(Rule):
    name = "jax-print-in-jit"
    severity = "warning"
    description = (
        "print() inside a traced function executes at TRACE time only "
        "(silent at run time) — or forces a host callback; use "
        "jax.debug.print for runtime values")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        traced = ctx.traced_functions()
        for fn in traced:
            for node in _body_nodes(fn, skip=traced):
                if (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Name)
                        and node.func.id == "print"):
                    yield self.finding(
                        ctx, node,
                        f"print() inside traced function "
                        f"{_fn_name(fn)!r}; use jax.debug.print")
