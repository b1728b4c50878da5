"""Silent-demotion heuristic (koordwatch rule 19).

A demotion branch that silently ``return 1``'s cannot be measured, so
every such branch goes through ONE chokepoint
(``Scheduler._note_demotion(reason, value)``) that emits a structured
reason, a metric and the flight-record entry; this rule pins that no
new demotion branch appears unreviewed.

Inside scheduler modules, a *demotion-resolving function* (name starts
with ``_effective_``: ``_effective_waves``, ``_effective_explain``, and
whatever joins them) may not:

  * ``return`` a bare constant (``return 1`` / ``return None`` / a bare
    ``return``) — a demoted level with no reason attached, or
  * assign a constant to a name the function later returns — the same
    silent demotion split across two statements.

Pass-throughs stay legal: ``return k`` / ``return self.explain_spec``
return the *resolved* value, and the chokepoint form
``return self._note_demotion("reason", 1)`` is a Call, not a constant.
A deliberate exception takes ``# koordlint: disable=silent-demotion-
branch`` with rationale.
"""

from __future__ import annotations

import ast
import re
from typing import Iterator, Set

from koordinator_tpu_torch.analysis.core import (
    Finding,
    ModuleContext,
    Rule,
    register,
)

_SCHED_PATH_RE = re.compile(r"scheduler/")
_RESOLVER_RE = re.compile(r"^_effective_")

_FUNC_DEFS = (ast.FunctionDef, ast.AsyncFunctionDef)


def _own_nodes(fn: ast.AST):
    """The function's OWN statement tree: every descendant except those
    inside nested function definitions (a local helper has its own
    contract and must not be flagged against the resolver)."""
    nested: Set[int] = set()
    for node in ast.walk(fn):
        if isinstance(node, _FUNC_DEFS) and node is not fn:
            for sub in ast.walk(node):
                nested.add(id(sub))
    for node in ast.walk(fn):
        if node is fn or id(node) in nested:
            continue
        yield node


def _returned_names(fn: ast.AST) -> Set[str]:
    """Names the function returns directly (``return k``) — constant
    assignments to these are the two-statement silent-demotion shape."""
    out: Set[str] = set()
    for node in _own_nodes(fn):
        if isinstance(node, ast.Return) and isinstance(node.value, ast.Name):
            out.add(node.value.id)
    return out


@register
class SilentDemotionBranch(Rule):
    name = "silent-demotion-branch"
    severity = "error"
    description = (
        "constant return (or constant assignment to a returned name) "
        "inside a demotion-resolving scheduler function (_effective_*): "
        "a branch that lowers the wave/explain level without routing "
        "through the reason-emitting chokepoint "
        "(Scheduler._note_demotion) is a silent demotion — exactly the "
        "unmeasured fallbacks the ROADMAP burn-down needs attributed; "
        "wrap the fallback value in _note_demotion(reason, value) or "
        "mark a deliberate exception with # koordlint: disable")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        if not _SCHED_PATH_RE.search(ctx.path):
            return
        for fn in ast.walk(ctx.tree):
            if not isinstance(fn, _FUNC_DEFS):
                continue
            if not _RESOLVER_RE.match(fn.name):
                continue
            returned = _returned_names(fn)
            for node in _own_nodes(fn):
                if isinstance(node, ast.Return):
                    if node.value is None or isinstance(node.value,
                                                        ast.Constant):
                        yield self.finding(
                            ctx, node,
                            f"{fn.name} returns a bare constant: a "
                            f"demotion with no structured reason — "
                            f"route it through "
                            f"self._note_demotion(reason, value)")
                elif isinstance(node, ast.Assign) and isinstance(
                        node.value, ast.Constant):
                    for target in node.targets:
                        if (isinstance(target, ast.Name)
                                and target.id in returned):
                            yield self.finding(
                                ctx, node,
                                f"{fn.name} assigns a constant to "
                                f"{target.id!r}, which it returns: the "
                                f"two-statement silent demotion — "
                                f"route the fallback through "
                                f"self._note_demotion(reason, value)")
