"""ColoPack: event-maintained packed arrays for the colo pass.

The colo device program (colo/step.py) consumes two state families:

  * per-node columns of the NodeResource pipeline — capacity, the
    node-reservation annotation split, the per-node strategy scalars,
    NodeMetric usage, and the per-class pod aggregate sums;
  * the elastic-quota tree — parent indices, min/max/weight/guarantee,
    live request/used — plus the cluster allocatable total.

When a :class:`~koordinator_tpu_torch.scheduler.snapshot_cache.SnapshotCache`
lives in the same process it *forwards* its existing store subscriptions
into this pack (``SnapshotCache.colo_pack``) instead of the pack opening
a second subscription chain — the "one upload, three consumers"
invariant koordlint rule 18 (``host-reconcile-in-colo-path``) pins for
new code in this package, the same shape as balance/pack.py. A
standalone koord-manager (no co-located scheduler) constructs the pack
with ``subscribe=True`` and it watches the store itself.

Exactness: node rows are built by the SAME row builders the host oracle
uses (``slocontroller.noderesource.node_static_row`` /
``node_metric_row``) so the device pass reads bit-identical inputs; the
static rows memoize on (node resourceVersion, config epoch) and the
metric rows refresh only for nodes whose NodeMetric or pod membership
changed — the per-pass cost is the delta, not the cluster. The quota
arrays memoize on the quota plugin's (tree_epoch, state_epoch) and the
cluster total on the node epoch — the `_runtime_by_name` memo satellite
made device-shaped.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set

import numpy as np

from koordinator_tpu_torch.api.objects import Node, NodeMetric, Pod
from koordinator_tpu_torch.api.resources import NUM_RESOURCES
from koordinator_tpu_torch.client.store import (
    KIND_NODE,
    KIND_NODE_METRIC,
    KIND_POD,
    EventType,
    ObjectStore,
)
from koordinator_tpu_torch.slocontroller.noderesource import (
    node_metric_row,
    node_static_row,
)
from koordinator_tpu_torch.utils.sloconfig import ColocationConfigSource


class ColoPack:
    """Packed node + quota state for the colo pass (see module doc).

    ``config_source`` is shared with the host-oracle
    ``NodeResourceController`` so both engines see the SAME effective
    (hot-reloaded) ColocationConfig. Construct via
    ``SnapshotCache.colo_pack`` (shared-process: events forwarded) or
    directly with ``subscribe=True`` (standalone manager)."""

    def __init__(self, store: ObjectStore,
                 config_source: ColocationConfigSource,
                 subscribe: bool = True) -> None:
        self.store = store
        self.config_source = config_source
        self._config_epoch_seen = -1
        # node table (store list order; rebuilt when the layout changes)
        self._nodes: List[Node] = []
        self._node_idx: Dict[str, int] = {}
        self._layout_stale = True
        self._static_dirty: Set[str] = set()
        self._metric_dirty: Set[str] = set()
        self._static_key: Dict[str, tuple] = {}
        R = NUM_RESOURCES
        self.capacity = np.zeros((0, R), np.float32)
        self.node_reserved = np.zeros((0, R), np.float32)
        self.system_reserved = np.zeros((0, R), np.float32)
        self.reclaim_pct = np.zeros((0, R), np.float32)
        self.mid_pct = np.zeros((0, R), np.float32)
        self.degrade_seconds = np.zeros(0, np.float64)
        self.node_used = np.zeros((0, R), np.float32)
        self.prod_reclaimable = np.zeros((0, R), np.float32)
        self.pod_all_used = np.zeros((0, R), np.float32)
        self.hp_used = np.zeros((0, R), np.float32)
        self.hp_request = np.zeros((0, R), np.float32)
        self.hp_max = np.zeros((0, R), np.float32)
        self.nm_time = np.zeros(0, np.float64)
        # assigned-pod membership per node (the metric-row join input)
        self._pods_on_node: Dict[str, Dict[str, Pod]] = {}
        self._pod_node: Dict[str, str] = {}
        # quota-side memos
        self._quota_memo: Optional[tuple] = None   # (epoch key, arrays)
        self._total_memo: Optional[tuple] = None   # (nodes epoch, vec)
        self._nodes_epoch = 0
        if subscribe:
            store.subscribe(KIND_NODE, self.on_node)
            store.subscribe(KIND_NODE_METRIC, self.on_metric)
            store.subscribe(KIND_POD, self.on_pod)

    # ------------------------------------------------------------------
    # events (called by the store OR forwarded by SnapshotCache)
    # ------------------------------------------------------------------
    def on_node(self, ev, node, old) -> None:
        self._nodes_epoch += 1
        name = node.meta.name
        if ev is EventType.DELETED or old is None:
            self._layout_stale = True
        else:
            # the store may swap in a NEW object instance on update
            # (store.update replaces the stored reference): re-anchor
            # the table entry so the static-row refresh reads the fresh
            # labels/annotations and the writeback mutates the LIVE
            # object, never a stale copy
            idx = self._node_idx.get(name)
            if idx is not None and not self._layout_stale:
                self._nodes[idx] = node
        self._static_dirty.add(name)
        self._metric_dirty.add(name)

    def on_metric(self, ev, nm, old) -> None:
        self._metric_dirty.add(nm.meta.name)

    def on_pod(self, ev, pod: Pod, old) -> None:
        key = pod.meta.key
        live = (ev is not EventType.DELETED and pod.is_assigned
                and not pod.is_terminated)
        prev_node = self._pod_node.pop(key, None)
        if prev_node is not None:
            self._pods_on_node.get(prev_node, {}).pop(key, None)
            self._metric_dirty.add(prev_node)
        if live:
            node = pod.spec.node_name
            self._pods_on_node.setdefault(node, {})[key] = pod
            self._pod_node[key] = node
            self._metric_dirty.add(node)
        elif old is not None and old.spec.node_name:
            self._metric_dirty.add(old.spec.node_name)

    # ------------------------------------------------------------------
    # refresh
    # ------------------------------------------------------------------
    def _refresh_layout(self) -> None:
        # layout rebuild runs only on node add/delete events, never
        # per pass — the one sanctioned store walk in this package
        # koordlint: disable=host-reconcile-in-colo-path
        nodes = self.store.list(KIND_NODE)
        self._nodes = nodes
        self._node_idx = {n.meta.name: i for i, n in enumerate(nodes)}
        N = len(nodes)
        R = NUM_RESOURCES
        # fixed column-array re-allocation on layout change (11 names)
        # koordlint: disable=host-reconcile-in-colo-path
        for field in ("capacity", "node_reserved", "system_reserved",
                      "reclaim_pct", "mid_pct", "node_used",
                      "prod_reclaimable", "pod_all_used", "hp_used",
                      "hp_request", "hp_max"):
            setattr(self, field, np.zeros((N, R), np.float32))
        self.degrade_seconds = np.zeros(N, np.float64)
        self.nm_time = np.zeros(N, np.float64)
        self._static_key.clear()
        self._static_dirty = {n.meta.name for n in nodes}
        self._metric_dirty = {n.meta.name for n in nodes}
        self._layout_stale = False

    def _refresh_static(self, config) -> None:
        config_epoch = self.config_source.epoch
        if config_epoch != self._config_epoch_seen:
            # policy scalars changed: every strategy row re-derives
            self._config_epoch_seen = config_epoch
            self._static_key.clear()
            self._static_dirty.update(self._node_idx)
        if not self._static_dirty:
            return
        # event-driven refresh, not per-pass work: only nodes whose
        # store object (or the effective config) changed re-derive their
        # strategy/annotation row — the shared row builder guarantees
        # bit-parity with the host oracle's gather
        # koordlint: disable=host-reconcile-in-colo-path
        for name in self._static_dirty:
            i = self._node_idx.get(name)
            if i is None:
                continue
            node = self._nodes[i]
            key = (node.meta.resource_version, config_epoch)
            if self._static_key.get(name) == key:
                continue
            strategy = config.strategy_for_node(
                node.meta.labels, node.meta.annotations)
            (self.capacity[i], self.node_reserved[i],
             self.system_reserved[i], self.reclaim_pct[i],
             self.mid_pct[i], self.degrade_seconds[i]) = node_static_row(
                node, strategy)
            self._static_key[name] = key
        self._static_dirty.clear()

    def _refresh_metrics(self) -> None:
        if not self._metric_dirty:
            return
        # event-driven refresh: only nodes whose NodeMetric or assigned
        # pod membership changed re-join their aggregate rows
        # koordlint: disable=host-reconcile-in-colo-path
        for name in self._metric_dirty:
            i = self._node_idx.get(name)
            if i is None:
                continue
            nm: Optional[NodeMetric] = self.store.get(
                KIND_NODE_METRIC, f"/{name}")
            pods = list(self._pods_on_node.get(name, {}).values())
            (self.node_used[i], self.prod_reclaimable[i],
             self.pod_all_used[i], self.hp_used[i], self.hp_request[i],
             self.hp_max[i]) = node_metric_row(nm, pods)
            self.nm_time[i] = nm.update_time if nm is not None else 0.0
        self._metric_dirty.clear()

    # ------------------------------------------------------------------
    # views
    # ------------------------------------------------------------------
    def view(self, now: float) -> dict:
        """Packed node arrays for the colo pass — refreshes lazily.
        ``degraded`` is the staleness decision at ``now`` (vectorized
        host compare, like the rebalance pack's has_metric)."""
        config = self.config_source.get()
        if self._layout_stale:
            self._refresh_layout()
        self._refresh_static(config)
        self._refresh_metrics()
        degraded = (self.nm_time <= 0.0) | (
            now - self.nm_time > self.degrade_seconds)
        return {
            "nodes": self._nodes,
            "capacity": self.capacity,
            "node_reserved": self.node_reserved,
            "system_reserved": self.system_reserved,
            "node_used": self.node_used,
            "pod_all_used": self.pod_all_used,
            "hp_used": self.hp_used,
            "hp_request": self.hp_request,
            "hp_max": self.hp_max,
            "prod_reclaimable": self.prod_reclaimable,
            "reclaim_pct": self.reclaim_pct,
            "mid_pct": self.mid_pct,
            "degraded": degraded,
            "cpu_policy": config.cluster_strategy.cpu_calculate_policy,
            "memory_policy": config.cluster_strategy.memory_calculate_policy,
        }

    def quota_view(self, quota_plugin) -> Optional[dict]:
        """Packed quota-tree arrays from the (scheduler-shared) elastic
        quota plugin's live caches, memoized on its (tree_epoch,
        state_epoch) and the cluster total on the node epoch — rebuilt
        only when a quota CR, a member pod, or a node changed. None when
        no quotas exist (the kernel's quota side runs empty-padded)."""
        total = self._cluster_total(quota_plugin)
        key = (quota_plugin.tree_epoch, quota_plugin.state_epoch,
               self._nodes_epoch)
        hit = self._quota_memo
        if hit is not None and hit[0] == key:
            return hit[1]
        tree = quota_plugin.packed_tree()
        arrays = None
        if tree is not None:
            G = len(tree.names)
            enable = (tree.enable_min_scale
                      if tree.enable_min_scale.shape[0] == G
                      else np.ones(G, bool))
            arrays = {
                "names": tree.names,
                "tree": tree,
                "q_parent": tree.parent.astype(np.int32),
                "q_level": tree.level.astype(np.int32),
                "q_min": tree.min.astype(np.float32),
                "q_max": tree.max.astype(np.float32),
                "q_weight": tree.shared_weight.astype(np.float32),
                "q_guarantee": tree.guarantee.astype(np.float32),
                "q_request": tree.request.astype(np.float32),
                # LEAF used (not the tree's parent-aggregated rolls):
                # the revoke mask is a leaf-level decision
                "q_used": quota_plugin.leaf_used_matrix(tree.names),
                "q_allow_lent": tree.allow_lent.astype(bool),
                "q_enable_scale": enable,
                "q_total": total.astype(np.float32),
            }
        self._quota_memo = (key, arrays)
        return arrays

    def _cluster_total(self, quota_plugin) -> np.ndarray:
        hit = self._total_memo
        if hit is not None and hit[0] == self._nodes_epoch:
            return hit[1]
        total = quota_plugin.cluster_total_vec(self.store)
        self._total_memo = (self._nodes_epoch, total)
        return total
