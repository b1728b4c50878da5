"""koordcolo discipline: the control-plane pass stays a tensor pass.

The whole point of ``koordinator_tpu_torch/colo/`` is ONE batched device
program over ONE shared encode of the cluster (the scheduler's
SnapshotCache feeds the pack; the DeviceSnapshot is the single mirror —
three consumers now). Two regressions would quietly rebuild the
per-node reconcile loops this subsystem replaced:

  * a per-node/per-quota Python ``for`` loop on the pass path — the
    whole-cluster overcommit degrades back to the reference's per-node
    reconcile iteration;
  * a second encode — ``store.list`` walks inside colo/ re-pack state
    the SnapshotCache-fed pack (or the quota plugin's epoch-memoized
    tree) already maintains, breaking the one-upload-three-consumers
    invariant.

Event-maintenance loops (the pack's dirty-row refresh) are legitimate
and carry pragmas documenting why they are event-driven, not per-pass.
The writeback itself routes through the host oracle's
``NodeResourceController.apply`` (slocontroller/), which is outside
this package on purpose — store writes are the oracle's job.
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

_COLO_PATH_RE = re.compile(r"(^|/)colo/[^/]+\.py$")


def _is_store_receiver(node: ast.AST) -> bool:
    if isinstance(node, ast.Attribute):
        return node.attr in ("store", "_store")
    if isinstance(node, ast.Name):
        return node.id in ("store", "_store")
    return False


@register
class HostReconcileInColoPath(Rule):
    name = "host-reconcile-in-colo-path"
    severity = "error"
    description = (
        "per-node/per-quota Python loop or a second state encode inside "
        "koordinator_tpu_torch/colo/: the colo pass is ONE batched tensor "
        "program over the pack-memo-shared snapshot — a host `for` loop "
        "re-grows the per-node reconcile loops it replaced, and a "
        "store.list walk re-encodes state the SnapshotCache-fed pack "
        "already maintains (one upload, three consumers); "
        "event-maintenance loops must carry a # koordlint: disable "
        "pragma documenting why they are event-driven, not per-pass")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        if not _COLO_PATH_RE.search(ctx.path):
            return
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.For):
                yield self.finding(
                    ctx, node,
                    "host for-loop in the colo path — express it as a "
                    "batched array op (or pragma a deliberate "
                    "event-maintenance loop)")
            elif (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "list"
                    and _is_store_receiver(node.func.value)):
                yield self.finding(
                    ctx, node,
                    "store.list inside colo/ is a second state encode — "
                    "consume the SnapshotCache-shared ColoPack view (or "
                    "the quota plugin's epoch-memoized tree) instead")
