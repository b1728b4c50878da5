"""Wire-decode safety rule.

The exemplar bug class is scheduler/config_v1beta2.py pre-fix: deep inside
``decode_component_config`` the code called ``entry.get("name")`` and
``args_obj.get("kind")`` on values that came off the YAML/JSON wire via
``profile.get("pluginConfig")`` — a wire payload of ``pluginConfig:
["oops"]`` or ``args: "foo"`` raised AttributeError out of a module whose
contract is "malformed wire input surfaces as ConfigValidationError".

The rule is a per-function heuristic over decode-shaped functions (name
starting with decode_/parse_/load_/from_): it tracks names that are
WIRE-DERIVED — bound by iterating a container read off another wire value
(``for entry in profile.get(...)``) or assigned from a ``.get()`` call —
and flags dict-protocol use of such a name (``.get``/``.items``/
``.keys``/``.values``/``.setdefault`` calls, or subscripting) unless the
function body guards that name with ``isinstance(name, dict)`` (Mapping
accepted). Top-level parameters are NOT flagged: the function signature is
the caller's contract; it is the nested, unvalidated layers that bite.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, Iterator, Set

from koordinator_tpu_torch.analysis.core import (
    Finding,
    ModuleContext,
    Rule,
    register,
)

_DECODE_NAME_RE = re.compile(r"^(decode|parse|load|from)_")

_DICT_METHODS = {"get", "items", "keys", "values", "setdefault"}

_FUNC_DEFS = (ast.FunctionDef, ast.AsyncFunctionDef)


def _is_get_call(node: ast.AST) -> bool:
    return (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "get")


def _contains_get_or_subscript(node: ast.AST) -> bool:
    return any(
        _is_get_call(sub) or isinstance(sub, ast.Subscript)
        for sub in ast.walk(node))


_MAPPING_TYPE_NAMES = {"dict", "Mapping", "MutableMapping", "OrderedDict"}


def _names_a_mapping_type(node: ast.AST) -> bool:
    types = node.elts if isinstance(node, ast.Tuple) else [node]
    for t in types:
        name = (t.id if isinstance(t, ast.Name)
                else t.attr if isinstance(t, ast.Attribute) else "")
        if name in _MAPPING_TYPE_NAMES:
            return True
    return False


def _isinstance_guarded(fn: ast.AST) -> Set[str]:
    """Names checked with isinstance(name, dict) — Mapping flavors
    accepted — anywhere in the function. Dominance is not computed (this
    is a lint heuristic: a dict guard anywhere signals the author
    considered the type), but the guard must actually name a mapping
    type; isinstance(x, str) narrowing does NOT license x.get()."""
    guarded: Set[str] = set()
    for node in ast.walk(fn):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Name)
                and node.func.id == "isinstance"
                and len(node.args) == 2
                and isinstance(node.args[0], ast.Name)
                and _names_a_mapping_type(node.args[1])):
            guarded.add(node.args[0].id)
    return guarded


@register
class UnguardedWireAccess(Rule):
    name = "wire-unguarded-access"
    severity = "error"
    description = (
        "dict-protocol access (.get()/subscript) on a nested wire value "
        "inside a decode function without an isinstance guard: malformed "
        "YAML/JSON raises AttributeError/TypeError instead of the decode "
        "path's validation error")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        for fn in ast.walk(ctx.tree):
            if not isinstance(fn, _FUNC_DEFS):
                continue
            if not _DECODE_NAME_RE.match(fn.name):
                continue
            yield from self._check_fn(ctx, fn)

    def _check_fn(self, ctx: ModuleContext,
                  fn: ast.AST) -> Iterator[Finding]:
        guarded = _isinstance_guarded(fn)
        derived: Dict[str, str] = {}  # name -> how it was derived
        # pass 1: collect wire-derived bindings (loop targets over wire
        # reads, and assignments from .get())
        for node in ast.walk(fn):
            if (isinstance(node, ast.For)
                    and isinstance(node.target, ast.Name)
                    and _contains_get_or_subscript(node.iter)):
                derived.setdefault(
                    node.target.id,
                    f"for {node.target.id} in <wire container>")
            elif isinstance(node, ast.Assign) and _is_get_call(node.value):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        derived.setdefault(
                            t.id, f"{t.id} = <wire>.get(...)")
        if not derived:
            return
        # pass 2: flag unguarded dict-protocol use of derived names
        for node in ast.walk(fn):
            name = None
            use = None
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and isinstance(node.func.value, ast.Name)
                    and node.func.attr in _DICT_METHODS):
                name = node.func.value.id
                use = f".{node.func.attr}()"
            elif (isinstance(node, ast.Subscript)
                  and isinstance(node.value, ast.Name)
                  and isinstance(node.ctx, ast.Load)):
                name = node.value.id
                use = "[...] subscript"
            if name is None or name not in derived or name in guarded:
                continue
            yield self.finding(
                ctx, node,
                f"{use} on wire-derived value {name!r} "
                f"({derived[name]}) in {fn.name!r} without "
                f"isinstance(..., dict) guard — malformed wire input "
                f"raises AttributeError instead of a validation error")
