"""Unbounded-scan heuristic.

The de-quadratification work of earlier rounds (packed prefilters in
preempt.py, the event-driven snapshot cache) exists because per-pod x
per-node Python loops inside the scheduling cycle are exactly what
collapses at 10k pods x 5k nodes. This rule flags the shape that keeps
trying to creep back in: inside scheduler modules, a ``for`` loop over a
fleet-sized iterable (pods/nodes/candidates/...) whose body contains
ANOTHER loop or comprehension over a fleet-sized iterable, with no
``break`` anywhere in the outer body — i.e. an uncapped full cross
product. A cap-with-break (preempt.py's candidate window) or a vectorized
escape satisfies the rule.
"""

from __future__ import annotations

import ast
import re
from typing import Iterator, Optional

from koordinator_tpu_torch.analysis.core import (
    Finding,
    ModuleContext,
    Rule,
    register,
)

_SCHED_PATH_RE = re.compile(r"(scheduler/|descheduler/)")

# fleet-sized iterable names (exact or plural-suffixed)
_FLEET_RE = re.compile(
    r"^(all_)?(nodes?|pods?|cands?|candidates?|feasible|live|victims?"
    r"|assigned|failed|rejected|bindings?)$")

_FUNC_DEFS = (ast.FunctionDef, ast.AsyncFunctionDef)


def _fleet_name(it: ast.AST) -> Optional[str]:
    """The fleet-ish name an iterable expression loops over, if any."""
    if isinstance(it, ast.Name) and _FLEET_RE.match(it.id):
        return it.id
    if isinstance(it, ast.Attribute) and _FLEET_RE.match(it.attr):
        return it.attr
    # nodes.values() / by_node.get(name, []) style: look one level in
    if isinstance(it, ast.Call):
        f = it.func
        if isinstance(f, ast.Attribute):
            return _fleet_name(f.value)
    return None


def _inner_fleet_loop(outer: ast.For) -> Optional[ast.AST]:
    """A nested for/comprehension over a fleet iterable inside `outer`."""
    for node in ast.walk(outer):
        if node is outer:
            continue
        if isinstance(node, ast.For) and _fleet_name(node.iter):
            return node
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                             ast.GeneratorExp)):
            for gen in node.generators:
                if _fleet_name(gen.iter):
                    return node
    return None


def _has_break(outer: ast.For) -> bool:
    for node in ast.walk(outer):
        if isinstance(node, ast.Break):
            return True
    return False


@register
class UnboundedScan(Rule):
    name = "unbounded-scan"
    severity = "warning"
    description = (
        "uncapped per-pod x per-node Python cross product inside a "
        "scheduler module: an outer loop over a fleet-sized iterable "
        "nests another fleet-sized loop with no break/cap — the O(P*N) "
        "shape the packed prefilters exist to avoid; add a candidate cap "
        "or vectorize")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        if not _SCHED_PATH_RE.search(ctx.path):
            return
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.For):
                continue
            outer_name = _fleet_name(node.iter)
            if outer_name is None:
                continue
            inner = _inner_fleet_loop(node)
            if inner is None:
                continue
            if _has_break(node):
                continue
            yield self.finding(
                ctx, node,
                f"loop over {outer_name!r} nests another fleet-sized "
                f"scan (line {inner.lineno}) with no cap/break: "
                f"O(P*N) Python work in the cycle")
