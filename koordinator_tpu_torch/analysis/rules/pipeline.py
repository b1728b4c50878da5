"""Pipelined-cycle readback discipline.

The cycle pipeline (scheduler/cycle.py CyclePipeline) exists because
``np.asarray`` on a device value is a host-blocking sync: the serial path
used to block the host for the whole kernel duration doing nothing. The
overlap only survives if the pipelined region keeps a SINGLE designated
sync point. This rule flags ``np.asarray`` / ``block_until_ready`` calls
lexically inside scheduler/cycle.py's pipelined region — the bodies of
``tracer.span("kernel")`` / ``tracer.span("overlap_wait")`` blocks —
unless the line carries a ``# koordlint: disable`` pragma documenting why
that sync is intended. A drive-by readback added "for debugging" would
silently serialize the pipeline again; with this rule it cannot land
without a visible pragma.
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

# the pipelined region lives in the cycle driver only
_CYCLE_PATH_RE = re.compile(r"scheduler/cycle\.py$")

# span names whose with-bodies form the pipelined region (dispatch ..
# readback): host code here runs while the device executes
_REGION_SPANS = {"kernel", "overlap_wait"}

_BLOCKING_TAILS = {"asarray", "block_until_ready"}


def _dotted_tail(node: ast.AST) -> str:
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return ""


def _is_region_item(item: ast.withitem) -> bool:
    call = item.context_expr
    return (isinstance(call, ast.Call)
            and _dotted_tail(call.func) == "span"
            and bool(call.args)
            and isinstance(call.args[0], ast.Constant)
            and call.args[0].value in _REGION_SPANS)


# the wave-kernel modules: pure device code end to end. A host transfer
# anywhere inside them runs INSIDE the fused dispatch's trace (or worse,
# per wave), destroying exactly the dispatch amortization the fused
# multi-wave design exists to buy.
_WAVE_PATH_RE = re.compile(r"models/(fused_waves|wave_chain)\.py$")

_WAVE_TRANSFER_TAILS = {"asarray", "item", "device_get",
                        "block_until_ready"}


def _is_device_asarray(func: ast.AST) -> bool:
    """jnp.asarray is a device-side dtype coercion, not a host transfer —
    only numpy's asarray (np./numpy./bare) pulls the value to host.
    Covers the spellings jnp.asarray and jax.numpy.asarray."""
    if not (isinstance(func, ast.Attribute) and func.attr == "asarray"):
        return False
    value = func.value
    if isinstance(value, ast.Name):
        return value.id == "jnp"
    return (isinstance(value, ast.Attribute) and value.attr == "numpy"
            and isinstance(value.value, ast.Name)
            and value.value.id == "jax")


@register
class ReadbackInWaveBody(Rule):
    name = "readback-in-wave-body"
    severity = "error"
    description = (
        "host transfer (np.asarray / .item() / jax.device_get / "
        "block_until_ready) inside a wave-kernel module "
        "(models/fused_waves.py, models/wave_chain.py): the wave body is "
        "traced into ONE fused device program precisely to amortize "
        "dispatch/readback overhead over K rounds — a host transfer "
        "inside it either breaks tracing or silently re-serializes every "
        "wave; keep all readback in the cycle driver's designated sync "
        "point or mark a deliberate exception with # koordlint: disable")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        if not _WAVE_PATH_RE.search(ctx.path):
            return
        for node in ast.walk(ctx.tree):
            if (isinstance(node, ast.Call)
                    and _dotted_tail(node.func) in _WAVE_TRANSFER_TAILS
                    and not _is_device_asarray(node.func)):
                yield self.finding(
                    ctx, node,
                    f"{_dotted_tail(node.func)} transfers to host inside "
                    "a wave-kernel module — the fused dispatch must stay "
                    "a single device program; read back in the cycle "
                    "driver instead")


# the mesh dispatch path: every host<->device transfer must route through
# the sharding-aware helpers (put_on_mesh pads + places per the mesh
# layout; merge_readback merges the compacted buffers from the per-shard
# copies with byte accounting). A bare device_put silently commits to ONE
# device — the first sharded consumer then pays a full reshard — and a
# bare asarray readback bypasses the per-shard observability.
_MESH_PATH_RE = re.compile(r"parallel/[^/]+\.py$")
_MESH_WRAPPERS = {"put_on_mesh", "merge_readback", "pad_for_sharding"}
_MESH_TRANSFER_TAILS = {"asarray", "device_put"}


@register
class UnshardedTransferInMeshPath(Rule):
    name = "unsharded-transfer-in-mesh-path"
    severity = "error"
    description = (
        "bare jax.device_put / np.asarray inside parallel/ or a mesh-path "
        "function of scheduler/cycle.py: mesh-dispatch transfers must go "
        "through put_on_mesh (pads non-divisible axes and places per the "
        "mesh sharding — a bare device_put commits to one device and "
        "forces a full reshard) and readbacks through merge_readback (the "
        "compacted per-shard merge with byte accounting); mark a "
        "deliberate exception with # koordlint: disable")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        in_parallel = bool(_MESH_PATH_RE.search(ctx.path))
        in_cycle = bool(_CYCLE_PATH_RE.search(ctx.path))
        if not (in_parallel or in_cycle):
            return
        # function scope map: parallel/ is mesh path everywhere except
        # inside the blessed wrapper definitions themselves; cycle.py's
        # mesh branch is its mesh-named functions
        wrapper_nodes = set()
        scopes = []
        for node in ast.walk(ctx.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if in_parallel and node.name in _MESH_WRAPPERS:
                    wrapper_nodes.add(node)
                elif in_cycle and "mesh" in node.name:
                    scopes.append(node)
        if in_parallel:
            exempt = set()
            for w in wrapper_nodes:
                exempt.update(id(n) for n in ast.walk(w))
            roots = [n for n in ast.walk(ctx.tree)
                     if id(n) not in exempt]
        else:
            roots = [n for s in scopes for n in ast.walk(s)]
        for node in roots:
            if (isinstance(node, ast.Call)
                    and _dotted_tail(node.func) in _MESH_TRANSFER_TAILS
                    and not _is_device_asarray(node.func)):
                yield self.finding(
                    ctx, node,
                    f"{_dotted_tail(node.func)} bypasses the mesh "
                    "sharding helpers — use put_on_mesh for uploads and "
                    "merge_readback for the compacted readback, or "
                    "annotate the intent with a pragma")


# the fused wave-replay loop (scheduler/cycle.py _replay_*/_fused_wave_*
# functions): per-pod store writes inside it are exactly what the
# overlapped-replay architecture batches away — a bind patch or condition
# write issued per pod re-serializes the replay against the store (lock +
# event fan-out per object) while the next wave executes. All writes must
# route through the designated batched flush sites (store.update_many
# bind transactions, the deferred-condition flush), which carry pragmas.
_SCHED_PATH_RE = re.compile(r"scheduler/[^/]+\.py$")
_REPLAY_FUNC_RE = re.compile(r"(replay|fused_wave|fused_no_node)")
_STORE_WRITE_TAILS = {"update", "add", "upsert", "delete", "update_many"}


def _is_store_receiver(node: ast.AST) -> bool:
    """self.store.update(...) / store.update(...) / self._store.add(...)."""
    if isinstance(node, ast.Attribute):
        return node.attr in ("store", "_store")
    if isinstance(node, ast.Name):
        return node.id in ("store", "_store")
    return False


@register
class StoreWriteInWaveReplayLoop(Rule):
    name = "store-write-in-wave-replay-loop"
    severity = "error"
    description = (
        "per-pod store write inside the fused wave-replay loop "
        "(scheduler/ functions named *replay*/*fused_wave*): the "
        "overlapped replay drains host work while the device executes "
        "the next wave, and per-object store calls re-serialize it "
        "against the store's lock and event fan-out — route bind patches "
        "and condition writes through the batched flush "
        "(store.update_many / the deferred-condition flush) or mark a "
        "designated flush site with # koordlint: disable")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        if not _SCHED_PATH_RE.search(ctx.path):
            return
        seen = set()
        for fn in ast.walk(ctx.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if not _REPLAY_FUNC_RE.search(fn.name):
                continue
            for node in ast.walk(fn):
                if (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and node.func.attr in _STORE_WRITE_TAILS
                        and _is_store_receiver(node.func.value)
                        and id(node) not in seen):
                    seen.add(id(node))
                    yield self.finding(
                        ctx, node,
                        f"store.{node.func.attr} inside the wave-replay "
                        "loop — per-pod writes re-serialize the "
                        "overlapped replay; batch through update_many or "
                        "the deferred-condition flush (pragma the "
                        "designated flush site)")


# koordguard dispatch deadlines (scheduler/deadline.py): every blocking
# device sync in the dispatch paths must route through the deadline
# watchdog (Scheduler._readback_sync / DeviceRebalancer's monitored
# sync_readback), or a slow-not-dead device wedges the cycle with the
# watchdog none the wiser. Two shapes are flagged: bare
# ``block_until_ready`` anywhere in scheduler/, parallel/ or balance/
# (the unambiguous device sync), and ``np.asarray`` readbacks lexically
# inside a ``span("readback")`` body (the rebalance pass's sync site) —
# the designated drain/merge sites carry pragmas.
_DEADLINE_DIR_RE = re.compile(r"(^|/)(scheduler|parallel|balance)/[^/]+\.py$")
_READBACK_SPANS = {"readback"}


def _is_readback_span_item(item: ast.withitem) -> bool:
    call = item.context_expr
    return (isinstance(call, ast.Call)
            and _dotted_tail(call.func) == "span"
            and bool(call.args)
            and isinstance(call.args[0], ast.Constant)
            and call.args[0].value in _READBACK_SPANS)


@register
class NakedDeviceSyncWithoutDeadline(Rule):
    name = "naked-device-sync-without-deadline"
    severity = "error"
    description = (
        "bare device sync (block_until_ready, or np.asarray inside a "
        "span(\"readback\") body) in a scheduler/, parallel/ or "
        "balance/ dispatch path: blocking syncs must route through the "
        "dispatch-deadline watchdog (Scheduler._readback_sync / the "
        "rebalancer's monitored sync closure) so a slow-not-dead device "
        "demotes the ladder instead of wedging the cycle "
        "(KOORD_TPU_DISPATCH_DEADLINE_MS); mark a designated "
        "drain/merge site with # koordlint: disable")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        if not _DEADLINE_DIR_RE.search(ctx.path):
            return
        seen = set()
        for node in ast.walk(ctx.tree):
            if (isinstance(node, ast.Call)
                    and _dotted_tail(node.func) == "block_until_ready"):
                seen.add(id(node))
                yield self.finding(
                    ctx, node,
                    "block_until_ready outside the deadline watchdog — "
                    "a slow-not-dead device blocks here forever; route "
                    "the sync through the monitored readback or pragma "
                    "the designated drain site")
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.With):
                continue
            if not any(_is_readback_span_item(i) for i in node.items):
                continue
            for sub in ast.walk(node):
                if (isinstance(sub, ast.Call)
                        and _dotted_tail(sub.func) == "asarray"
                        and not _is_device_asarray(sub.func)
                        and id(sub) not in seen):
                    seen.add(id(sub))
                    yield self.finding(
                        ctx, sub,
                        "np.asarray readback inline in a "
                        "span(\"readback\") body — run the sync through "
                        "the deadline watchdog (a monitored closure) or "
                        "pragma the designated site")


@register
class BlockingReadbackInPipeline(Rule):
    name = "blocking-readback-in-pipeline"
    severity = "error"
    description = (
        "np.asarray / block_until_ready inside scheduler/cycle.py's "
        "pipelined region (the span(\"kernel\")/span(\"overlap_wait\") "
        "bodies) without a pragma: every readback is a host-blocking "
        "device sync, and an undeclared one silently re-serializes the "
        "cycle pipeline; keep the single designated sync point or mark "
        "the new one with # koordlint: disable")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        if not _CYCLE_PATH_RE.search(ctx.path):
            return
        seen = set()
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.With):
                continue
            if not any(_is_region_item(item) for item in node.items):
                continue
            for sub in ast.walk(node):
                if (isinstance(sub, ast.Call)
                        and _dotted_tail(sub.func) in _BLOCKING_TAILS
                        and id(sub) not in seen):
                    seen.add(id(sub))
                    yield self.finding(
                        ctx, sub,
                        f"{_dotted_tail(sub.func)} blocks the host inside "
                        "the pipelined kernel region — the overlap dies "
                        "silently; move it past the designated sync point "
                        "or annotate the intent with a pragma")
