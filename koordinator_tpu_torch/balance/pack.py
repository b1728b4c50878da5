"""RebalancePack: event-maintained packed arrays for the rebalance pass.

Moved here from ``descheduler/lownodeload.py`` (where it was
``RebalancePackCache``) so the scheduler and the descheduler share ONE
encode of the cluster: when a :class:`SnapshotCache` lives in the same
process it *forwards* its existing store subscriptions into the pack
(``SnapshotCache.rebalance_pack``) instead of the pack opening a second
subscription chain and walking the store again — the "one upload, two
consumers" invariant koordlint rule 16 (`host-loop-in-rebalance-path`)
pins for new code in this package.

The reference keeps incremental caches and walks them per run
(utilization_util.go reads informer caches, not the API server); the
batch analog keeps the pod/node state PACKED so the victim pass is pure
array math — the store walk and object packing move out of the per-pass
cost entirely. Slots are append-only (compacted when >50% dead) so
masked views preserve store insertion order, which the stable sort
relies on for exact victim-set parity with the serial C++ floor AND the
device tensor pass (balance/step.py).
"""

from __future__ import annotations

import weakref
from typing import Dict, List, Optional

import numpy as np

from koordinator_tpu_torch.api.objects import NodeMetric, Pod
from koordinator_tpu_torch.api.resources import (
    NUM_RESOURCES,
    RESOURCE_INDEX,
    ResourceName,
)
from koordinator_tpu_torch.client.store import (
    KIND_NODE,
    KIND_NODE_METRIC,
    KIND_POD,
    ObjectStore,
)

CPU = RESOURCE_INDEX[ResourceName.CPU]


def has_pdb_like_guard(pod: Pod) -> bool:
    """The descheduler opt-out annotation: such pods are never victims."""
    return pod.meta.annotations.get(
        "descheduler.alpha.kubernetes.io/evict") == "false"


# store -> {expiration -> RebalancePack}; weak so stores die normally
_PACKS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


class RebalancePack:
    """Packed node usage/metric columns + assigned-pod rows (see module
    doc). Construct via :meth:`for_store` (standalone descheduler:
    subscribes itself) or with ``subscribe=False`` when a SnapshotCache
    forwards its events (shared-process deployments)."""

    _GROW = 1024

    @classmethod
    def for_store(cls, store: ObjectStore,
                  expiration_seconds: float) -> "RebalancePack":
        """One pack per (store, expiration): ObjectStore has no
        unsubscribe, so every construction would leak a live handler —
        repeat LowNodeLoad constructions on the same store (per-pass
        plugin re-inits) must share the subscription."""
        by_exp = _PACKS.setdefault(store, {})
        pack = by_exp.get(expiration_seconds)
        if pack is None:
            pack = cls(store, expiration_seconds)
            by_exp[expiration_seconds] = pack
        return pack

    def __init__(self, store: ObjectStore, expiration_seconds: float,
                 subscribe: bool = True) -> None:
        self.store = store
        self.expiration = expiration_seconds
        # node side
        self._node_names: List[str] = []
        self._node_idx: Dict[str, int] = {}
        self.alloc = np.zeros((0, NUM_RESOURCES), np.float32)
        self.usage_pct = np.zeros((0, NUM_RESOURCES), np.float32)
        self.nm_time = np.zeros(0, np.float64)
        self.has_raw = np.zeros(0, bool)
        self._nodes_stale = True
        # pod side (append-only slots)
        self._slot: Dict[str, int] = {}
        self._cap = 0
        self._len = 0
        self._dead = 0
        self.pod_alive = np.zeros(0, bool)
        self.pod_node_name: List[Optional[str]] = []
        self.pod_node = np.zeros(0, np.int64)
        self._pod_node_stale = True
        self.pod_prio = np.zeros(0, np.int64)
        self.pod_cpu = np.zeros(0, np.float32)
        self.pod_req = np.zeros((0, NUM_RESOURCES), np.float32)
        self.pod_movable = np.zeros(0, bool)
        self.pod_ref: List[Optional[Pod]] = []
        if subscribe:
            store.subscribe(KIND_NODE, self.on_node)
            store.subscribe(KIND_NODE_METRIC, self.on_metric)
            store.subscribe(KIND_POD, self.on_pod)

    # -- events (called by the store OR forwarded by SnapshotCache) ----
    def on_node(self, ev, node, old) -> None:
        self._nodes_stale = True

    def on_metric(self, ev, nm, old) -> None:
        # metric rows refresh lazily with the node table; a metric-only
        # update just recomputes that row
        self._nodes_stale = True

    def on_pod(self, ev, pod: Pod, old) -> None:
        from koordinator_tpu_torch.client.store import EventType

        key = pod.meta.key
        slot = self._slot.get(key)
        live = (ev is not EventType.DELETED and pod.is_assigned
                and not pod.is_terminated)
        if not live:
            if slot is not None and self.pod_alive[slot]:
                self.pod_alive[slot] = False
                self.pod_ref[slot] = None
                self._dead += 1
            if ev is EventType.DELETED:
                # a deleted-then-recreated pod must land in a FRESH slot:
                # the store dict re-inserts it at the end, and slot order
                # must track store insertion order for sort-parity with
                # the cold pass / C++ floor (terminated-in-place pods keep
                # their slot — the store preserves their dict position)
                self._slot.pop(key, None)
            return
        if slot is None:
            if self._len == self._cap:
                grow = max(self._GROW, self._cap)
                self.pod_alive = np.concatenate(
                    [self.pod_alive, np.zeros(grow, bool)])
                self.pod_node = np.concatenate(
                    [self.pod_node, np.full(grow, -1, np.int64)])
                self.pod_prio = np.concatenate(
                    [self.pod_prio, np.zeros(grow, np.int64)])
                self.pod_cpu = np.concatenate(
                    [self.pod_cpu, np.zeros(grow, np.float32)])
                self.pod_req = np.concatenate(
                    [self.pod_req,
                     np.zeros((grow, NUM_RESOURCES), np.float32)])
                self.pod_movable = np.concatenate(
                    [self.pod_movable, np.zeros(grow, bool)])
                self.pod_node_name.extend([None] * grow)
                self.pod_ref.extend([None] * grow)
                self._cap += grow
            slot = self._len
            self._slot[key] = slot
            self._len += 1
        elif not self.pod_alive[slot]:
            self._dead -= 1
        self.pod_alive[slot] = True
        self.pod_node_name[slot] = pod.spec.node_name
        self.pod_prio[slot] = pod.spec.priority or 0
        self.pod_cpu[slot] = pod.spec.requests[ResourceName.CPU]
        self.pod_req[slot] = pod.spec.requests.to_vector()
        self.pod_movable[slot] = (
            pod.meta.owner_kind != "DaemonSet"
            and not has_pdb_like_guard(pod))
        self.pod_ref[slot] = pod
        self._pod_node_stale = True

    # -- refresh -------------------------------------------------------
    def _refresh_nodes(self) -> None:
        nodes = self.store.list(KIND_NODE)
        names = [n.meta.name for n in nodes]
        remap = names != self._node_names
        if remap:
            self._node_names = names
            self._node_idx = {n: i for i, n in enumerate(names)}
            self._pod_node_stale = True
        N = len(nodes)
        self.alloc = np.zeros((N, NUM_RESOURCES), np.float32)
        self.usage_pct = np.zeros((N, NUM_RESOURCES), np.float32)
        self.nm_time = np.zeros(N, np.float64)
        self.has_raw = np.zeros(N, bool)
        # event-driven refresh, not per-pass work: the rows rebuilt here
        # are exactly the nodes whose store objects changed since the
        # last view (the pass itself is pure array math on the result)
        # koordlint: disable=host-loop-in-rebalance-path
        for i, node in enumerate(nodes):
            self.alloc[i] = node.allocatable.to_vector()
            nm: Optional[NodeMetric] = self.store.get(
                KIND_NODE_METRIC, f"/{node.meta.name}")
            if nm is None or nm.update_time <= 0:
                continue
            usage = nm.node_metric.node_usage.to_vector()
            a = self.alloc[i]
            with np.errstate(divide="ignore", invalid="ignore"):
                self.usage_pct[i] = np.where(
                    a > 0, usage * 100.0 / np.maximum(a, 1e-9), 0.0)
            self.nm_time[i] = nm.update_time
            self.has_raw[i] = True
        self._nodes_stale = False

    def _compact(self) -> None:
        keep = np.nonzero(self.pod_alive[: self._len])[0]
        self.pod_alive = np.concatenate(
            [np.ones(keep.size, bool), np.zeros(self._cap - keep.size, bool)])
        # four fixed column arrays, not a per-pod walk
        # koordlint: disable=host-loop-in-rebalance-path
        for arr_name in ("pod_node", "pod_prio", "pod_cpu", "pod_movable"):
            arr = getattr(self, arr_name)
            packed = arr[keep]
            arr[: keep.size] = packed
            arr[keep.size:] = 0
        self.pod_req[: keep.size] = self.pod_req[keep]
        self.pod_req[keep.size:] = 0
        names = [self.pod_node_name[k] for k in keep]
        refs = [self.pod_ref[k] for k in keep]
        pad = self._cap - keep.size
        self.pod_node_name = names + [None] * pad
        self.pod_ref = refs + [None] * pad
        self._slot = {
            refs[j].meta.key: j for j in range(keep.size)
        }
        self._len = keep.size
        self._dead = 0

    def view(self, now: float):
        """(packed arrays dict) for the victim pass — refreshes lazily."""
        if self._nodes_stale:
            self._refresh_nodes()
        if self._dead * 2 > max(1, self._len):
            self._compact()
        if self._pod_node_stale:
            idx = self._node_idx
            # string node-name -> layout-index remap: runs only when the
            # node layout or a pod's placement changed (event-flagged)
            # koordlint: disable=host-loop-in-rebalance-path
            for j in range(self._len):
                name = self.pod_node_name[j]
                self.pod_node[j] = idx.get(name, -1) if name else -1
            self._pod_node_stale = False
        has_metric = self.has_raw & (
            now - self.nm_time < self.expiration)
        return {
            "alloc": self.alloc,
            "usage_pct": self.usage_pct,
            "has_metric": has_metric,
            "pod_alive": self.pod_alive[: self._len],
            "pod_node": self.pod_node[: self._len],
            "pod_prio": self.pod_prio[: self._len],
            "pod_cpu": self.pod_cpu[: self._len],
            "pod_req": self.pod_req[: self._len],
            "pod_movable": self.pod_movable[: self._len],
        }
