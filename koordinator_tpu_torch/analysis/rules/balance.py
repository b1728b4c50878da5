"""koordbalance discipline: the rebalance path stays a tensor pass.

The whole point of ``koordinator_tpu_torch/balance/`` is ONE batched device
program over ONE shared encode of the cluster (the scheduler's
SnapshotCache feeds the pack; the DeviceSnapshot is the single mirror).
Two regressions would quietly rebuild the per-node Go loops this
subsystem replaced:

  * a per-node/per-pod Python ``for`` loop on the pass path — the
    10k-pod victim selection degrades back to host iteration;
  * a second pod encode — ``store.list(KIND_POD)`` walks inside
    balance/ re-pack the cluster the SnapshotCache already maintains,
    breaking the one-upload-two-consumers invariant.

Event-maintenance loops (the pack's node-table refresh, the
string->index remap) are legitimate and carry pragmas documenting why
they are event-driven, not per-pass.
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

_BALANCE_PATH_RE = re.compile(r"(^|/)balance/[^/]+\.py$")


def _is_store_receiver(node: ast.AST) -> bool:
    if isinstance(node, ast.Attribute):
        return node.attr in ("store", "_store")
    if isinstance(node, ast.Name):
        return node.id in ("store", "_store")
    return False


@register
class HostLoopInRebalancePath(Rule):
    name = "host-loop-in-rebalance-path"
    severity = "error"
    description = (
        "per-node Python loop or a second pod encode inside "
        "koordinator_tpu_torch/balance/: the rebalance pass is ONE batched "
        "tensor program over the pack-memo-shared snapshot — a host "
        "`for` loop re-grows the per-node Go loops it replaced, and a "
        "store.list(KIND_POD) walk re-encodes the cluster the "
        "SnapshotCache already maintains (one upload, two consumers); "
        "event-maintenance loops must carry a # koordlint: disable "
        "pragma documenting why they are event-driven, not per-pass")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        if not _BALANCE_PATH_RE.search(ctx.path):
            return
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.For):
                yield self.finding(
                    ctx, node,
                    "host for-loop in the rebalance path — express it "
                    "as a batched array op (or pragma a deliberate "
                    "event-maintenance loop)")
            elif (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "list"
                    and _is_store_receiver(node.func.value)
                    and node.args
                    and isinstance(node.args[0], ast.Name)
                    and node.args[0].id == "KIND_POD"):
                yield self.finding(
                    ctx, node,
                    "store.list(KIND_POD) inside balance/ is a second "
                    "pod encode — consume the SnapshotCache-shared "
                    "RebalancePack view instead")
