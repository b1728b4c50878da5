"""Steady-state compile hygiene (koordlint rule 20, the AST half).

The warm-up ladder (scheduler/warmup.py) promises that after startup a
scheduler never compiles in the hot path: every step build must route
through the KEYED step-cache chokepoints (``_get_step`` /
``_get_fused_step`` / ``_get_chain_step`` and the rebalance/colo
``_get_step`` twins), because those are the only sites that (a) consult
the in-memory cache the warm-up pre-populated, (b) count hits/misses,
and (c) record the persistent warm-up rung for the next process. A
``build_*_step`` call ANYWHERE ELSE in the driver packages is a compile
the cache layer cannot see — it would recompile on every call, dodge
the steady-state miss guard, and silently undo the cold-start work.

The runtime half lives in the sim harness: after warm-up completes, a
step-cache miss outside the warmup/ladder-transition/restart contexts
bumps ``koord_scheduler_steady_state_compiles_total`` and the report's
flag counters, which the coldstart gate asserts stay flat to the first
bind.

Scope: ``scheduler/``, ``balance/`` and ``colo/`` driver modules — the
builders themselves live in ``models/``/``ops/``/``parallel/`` and
compose freely there, and ``scheduler/warmup.py`` replays rungs through
builders by design. A deliberate exception takes ``# koordlint:
disable=compile-in-steady-state`` with rationale.
"""

from __future__ import annotations

import ast
import re
from typing import Iterator

from koordinator_tpu_torch.analysis.core import (
    Finding,
    ModuleContext,
    Rule,
    register,
)

# driver packages whose step compiles must be keyed-cache-routed
_DRIVER_PATH_RE = re.compile(r"(scheduler|balance|colo)/[^/]+\.py$")
# the warm-up ladder replays rungs through the builders by design
_EXEMPT_PATH_RE = re.compile(r"scheduler/warmup\.py$")
# a step-builder callable, by name: build_rebalance_step,
# build_sharded_full_chain_step, build_best_full_chain_step, ...
_BUILDER_RE = re.compile(r"^build_\w*step$")
# the keyed chokepoints: _get_step, _get_fused_step, _get_chain_step...
_CHOKEPOINT_RE = re.compile(r"^_get_\w*step$")

_FUNC_DEFS = (ast.FunctionDef, ast.AsyncFunctionDef)


def _call_name(node: ast.Call) -> str:
    func = node.func
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return ""


@register
class CompileInSteadyState(Rule):
    name = "compile-in-steady-state"
    severity = "error"
    description = (
        "a step builder (build_*_step) called outside the keyed "
        "step-cache chokepoints (_get_*step) in a driver module: the "
        "compile bypasses the in-memory cache the warm-up ladder "
        "pre-populated, the hit/miss counters, the steady-state miss "
        "guard AND the persistent warm-up rung index — route it "
        "through the module's _get_*step, or pragma a deliberate "
        "exception")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        if not _DRIVER_PATH_RE.search(ctx.path):
            return
        if _EXEMPT_PATH_RE.search(ctx.path):
            return
        parents = ctx.parent_map()
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            name = _call_name(node)
            if not _BUILDER_RE.match(name):
                continue
            # walk up through ALL enclosing functions; any _get_*step
            # frame on the way legitimizes the call (a retry/span
            # closure inside a chokepoint is still chokepoint-routed)
            cur = node
            enclosing = None
            routed = False
            while cur in parents:
                cur = parents[cur]
                if isinstance(cur, _FUNC_DEFS):
                    if enclosing is None:
                        enclosing = cur
                    if _CHOKEPOINT_RE.match(cur.name):
                        routed = True
                        break
            if routed:
                continue
            where = (f"inside {enclosing.name!r}" if enclosing is not None
                     else "at module scope")
            yield self.finding(
                ctx, node,
                f"{name}() {where}: step compile outside the keyed "
                f"step-cache chokepoints (_get_*step) — in steady "
                f"state this recompiles on every call and bypasses the "
                f"warm-up/miss-guard machinery")
