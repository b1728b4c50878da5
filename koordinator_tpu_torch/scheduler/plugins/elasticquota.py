"""ElasticQuota plugin host side: the group quota manager cache.

Reference `plugins/elasticquota/core/group_quota_manager.go`: maintains the
quota tree from ElasticQuota CRs, tracks request/used deltas as pods come and
go, and exposes the packed tree to the admission kernel (ops/quota.py). Also
hosts the overuse revoke walk (quota_overuse_revoke.go)."""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from koordinator_tpu_torch.api.objects import ElasticQuota, Pod
from koordinator_tpu_torch.api.resources import NUM_RESOURCES
from koordinator_tpu_torch.client.store import (
    KIND_ELASTIC_QUOTA,
    KIND_POD,
    EventType,
    ObjectStore,
)
from koordinator_tpu_torch.scheduler.frameworkext import CycleContext, Plugin


class ElasticQuotaPlugin(Plugin):
    name = "ElasticQuota"

    def __init__(self) -> None:
        self.quotas: Dict[str, ElasticQuota] = {}
        self.used: Dict[str, np.ndarray] = {}     # leaf quota -> used vector
        self.pending: Dict[str, np.ndarray] = {}  # leaf quota -> pending requests
        # epochs for the tree/runtime memos (koordcolo): the tree epoch
        # moves on quota CR events, the state epoch on any used/pending
        # mutation, the node epoch on node events (cluster total)
        self.tree_epoch = 0
        self.state_epoch = 0
        self.nodes_epoch = 0
        self._tree_memo: Optional[tuple] = None     # (key, tree)
        self._runtime_memo: Optional[tuple] = None  # (key, runtime)
        # the device colo pass's published runtime/revoke decisions:
        # (epoch key, names, runtime[G,R], over[G,R], mask[G]) — consumed
        # by the revoke controller while the key matches the live epochs
        self.device_runtime: Optional[tuple] = None

    def register(self, store: ObjectStore) -> None:
        from koordinator_tpu_torch.client.store import KIND_NODE

        store.subscribe(KIND_ELASTIC_QUOTA, self._on_quota)
        store.subscribe(KIND_POD, self._on_pod)
        # cluster total (and hence every runtime quota) moves with node
        # allocatable — including the batch/mid axes the colo pass
        # itself publishes; the epoch keeps the runtime memo honest
        store.subscribe(KIND_NODE, self._on_node, replay=False)

    def _on_node(self, ev: EventType, node, old) -> None:
        self.nodes_epoch += 1

    @property
    def epoch_key(self) -> tuple:
        return (self.tree_epoch, self.state_epoch, self.nodes_epoch)

    def services(self):
        """frameworkext services endpoints (/apis/v1/plugins/ElasticQuota/...)."""
        return {
            "quotas": lambda: {
                name: {
                    "min": dict(q.min.quantities),
                    "max": dict(q.max.quantities),
                    "used": self.used.get(name, np.zeros(NUM_RESOURCES)).tolist(),
                }
                for name, q in sorted(self.quotas.items())
            }
        }

    def _on_quota(self, ev: EventType, q: ElasticQuota, old) -> None:
        if ev is EventType.DELETED:
            self.quotas.pop(q.meta.name, None)
        else:
            self.quotas[q.meta.name] = q
        self.tree_epoch += 1

    def _vec(self, cache: Dict[str, np.ndarray], name: str) -> np.ndarray:
        if name not in cache:
            cache[name] = np.zeros(NUM_RESOURCES, np.float32)
        return cache[name]

    @staticmethod
    def _bucket(pod: Pod) -> Optional[str]:
        """Which cache a pod contributes to: pending (unassigned, live), used
        (assigned, live), or none (terminated)."""
        if pod.is_terminated:
            return None
        return "used" if pod.is_assigned else "pending"

    def _apply(self, name: str, bucket: Optional[str], vec: np.ndarray,
               sign: float) -> None:
        if bucket is None:
            return
        cache = self.used if bucket == "used" else self.pending
        self._vec(cache, name)
        cache[name] = np.maximum(cache[name] + sign * vec, 0.0)
        self.state_epoch += 1

    def _on_pod(self, ev: EventType, pod: Pod, old) -> None:
        name = pod.quota_name
        if not name:
            return
        vec = pod.spec.requests.to_vector()
        if ev is EventType.ADDED:
            self._apply(name, self._bucket(pod), vec, +1.0)
        elif ev is EventType.MODIFIED:
            old_bucket = self._bucket(old) if old is not None else None
            new_bucket = self._bucket(pod)
            if old_bucket != new_bucket:
                self._apply(name, old_bucket, vec, -1.0)
                self._apply(name, new_bucket, vec, +1.0)
        elif ev is EventType.DELETED:
            self._apply(name, self._bucket(pod), vec, -1.0)

    def quota_list(self) -> List[ElasticQuota]:
        return list(self.quotas.values())

    def request_by_quota(self) -> Dict[str, np.ndarray]:
        """Group demand from the live caches (see ops.quota.merge_group_request)."""
        from koordinator_tpu_torch.ops.quota import merge_group_request

        return merge_group_request(self.pending, self.used)

    def packed_tree(self):
        """The packed QuotaTreeArrays from the live caches, memoized on
        (tree_epoch, state_epoch) — a reconcile tick on an unchanged
        cluster reuses the previous build instead of re-walking every
        quota. Returns None when no quotas exist."""
        from koordinator_tpu_torch.ops.quota import build_quota_tree

        key = (self.tree_epoch, self.state_epoch)
        hit = self._tree_memo
        if hit is not None and hit[0] == key:
            return hit[1]
        quotas = self.quota_list()
        tree = None
        if quotas:
            tree = build_quota_tree(
                quotas,
                pod_requests_by_quota=self.request_by_quota(),
                used_by_quota=self.used,
            )
        self._tree_memo = (key, tree)
        return tree

    @staticmethod
    def cluster_total_vec(store: ObjectStore) -> np.ndarray:
        """Cluster allocatable total as the packed [R] f32 vector — the
        exact value the runtime fold divides (single home: the host
        oracle, the revoke controller, and the colo pack all ship this
        vector, so the device fold's input is bit-identical)."""
        from koordinator_tpu_torch.api.resources import ResourceList
        from koordinator_tpu_torch.client.store import KIND_NODE

        total = ResourceList()
        for node in store.list(KIND_NODE):
            total = total.add(node.allocatable)
        return total.to_vector()

    def leaf_used_matrix(self, names) -> np.ndarray:
        """Per-group LEAF used rows aligned to ``names`` — what the
        overuse revoke loop checks against runtime (the aggregated tree
        ``used`` rolls children into parents; revocation is leaf-level,
        quota_overuse_revoke.go walks direct members only)."""
        out = np.zeros((len(names), NUM_RESOURCES), np.float32)
        for i, name in enumerate(names):
            vec = self.used.get(name)
            if vec is not None:
                out[i] = vec
        return out

    def tree_snapshot(self, store: ObjectStore):
        """(tree, runtime[G, R]) from the live caches + node totals — the one
        shared snapshot the revoke controller and the preemptor both derive
        runtime quotas from. Returns None when no quotas exist. Memoized on
        (tree_epoch, state_epoch, nodes_epoch): nothing changed -> the
        previous runtime matrix is returned without recomputing the fold."""
        from koordinator_tpu_torch.ops.quota import compute_runtime_quotas

        tree = self.packed_tree()
        if tree is None:
            return None
        key = self.epoch_key
        hit = self._runtime_memo
        if hit is not None and hit[0] == key:
            return tree, hit[1]
        runtime = compute_runtime_quotas(tree, self.cluster_total_vec(store))
        self._runtime_memo = (key, runtime)
        return tree, runtime

    # ---- koordcolo: the device pass's published quota decisions ----------
    def set_device_runtime(self, names, runtime, over, mask, key) -> None:
        """The colo reconciler lands the device fold's outputs here;
        they stay authoritative while ``key`` matches the live epochs
        (any quota/pod/node event invalidates them until the next colo
        pass re-publishes)."""
        self.device_runtime = (tuple(key), list(names), runtime, over, mask)

    def fresh_device_runtime(self) -> Optional[tuple]:
        hit = self.device_runtime
        if hit is None or hit[0] != self.epoch_key:
            return None
        return hit

    def revoke_controller(self, store: ObjectStore, args) -> "QuotaOveruseRevokeController":
        return QuotaOveruseRevokeController(self, store, args)

    @staticmethod
    def victim_order(name: str, pods: List[Pod]) -> List[Pod]:
        """The overuse victim ordering (quota_overuse_revoke.go): live assigned
        members of the group, lowest priority first, youngest first within a
        priority. Single home for the policy — the revoke controller walks it."""
        return sorted(
            (p for p in pods
             if p.quota_name == name and p.is_assigned and not p.is_terminated),
            key=lambda p: (p.spec.priority or 0, -p.meta.creation_timestamp),
        )


class QuotaOveruseRevokeController:
    """Overuse revocation loop (quota_overuse_revoke.go): every
    revokePodInterval, recompute runtime quotas from the live tree and evict
    members of groups whose used exceeds runtime — but only after the group
    has been continuously over-quota for delayEvictTime (grace for transient
    overshoot after a min shrink). Gated by ElasticQuotaArgs.monitorAllQuotas."""

    def __init__(self, plugin: ElasticQuotaPlugin, store: ObjectStore, args,
                 evictor=None):
        from koordinator_tpu_torch.descheduler.evictions import EvictionAPIEvictor

        self.plugin = plugin
        self.store = store
        self.args = args
        # evictions route through the shared PDB/evictability machinery
        self.evictor = evictor or EvictionAPIEvictor(store)
        self._last_run: float = 0.0
        self._over_since: Dict[str, float] = {}

    def _runtime_by_name(self, device=None) -> Dict[str, np.ndarray]:
        """Runtime quota per group. With a FRESH device colo pass
        published on the plugin (koordcolo), its runtime matrix is
        authoritative — decision-identical to the host fold by the
        run_colo_parity gate; otherwise the (epoch-memoized) host
        snapshot computes it. ``device`` is the caller's single
        fresh_device_runtime() read, so one pass cannot mix a device
        runtime with a host-path mask decision."""
        if device is not None:
            _key, names, runtime, _over, _mask = device
            return {name: runtime[i] for i, name in enumerate(names)}
        snap = self.plugin.tree_snapshot(self.store)
        if snap is None:
            return {}
        tree, runtime = snap
        return {name: runtime[i] for i, name in enumerate(tree.names)}

    def reconcile(self, now: float) -> List[str]:
        """Returns keys of evicted pods."""
        if not self.args.monitor_all_quotas:
            return []
        if now - self._last_run < self.args.revoke_pod_interval_seconds:
            return []
        self._last_run = now
        device = self.plugin.fresh_device_runtime()
        runtime = self._runtime_by_name(device)
        if not runtime:
            return []
        # grace tracking: a group only becomes revocable after delayEvictTime.
        # With a fresh device pass the over-runtime candidate detection
        # consumes the kernel's revoke mask (the host compare retained below
        # as the oracle path and for host/off modes).
        revocable: Dict[str, np.ndarray] = {}
        device_idx = ({n: i for i, n in enumerate(device[1])}
                      if device is not None else None)
        for name, used in self.plugin.used.items():
            rt = runtime.get(name)
            if rt is None:
                continue
            if device_idx is not None and name in device_idx:
                over_now = bool(device[4][device_idx[name]])
            else:
                over_now = bool((np.maximum(used - rt, 0.0) > 0).any())
            if over_now:
                since = self._over_since.setdefault(name, now)
                if now - since >= self.args.delay_evict_time_seconds:
                    revocable[name] = rt
            else:
                self._over_since.pop(name, None)
        if not revocable:
            return []
        from koordinator_tpu_torch.descheduler.evictions import EvictionBlocked

        pods = self.store.list(KIND_POD)
        evicted = []
        # walk EVERY member of each over-quota group in victim order, not just
        # the minimal victim set: a blocked member (PDB / non-evictable) must
        # not shield the group from reclamation — the next member is tried
        for name, rt in revocable.items():
            over = np.maximum(self.plugin.used.get(name, 0.0) - rt, 0.0)
            for pod in self.plugin.victim_order(name, pods):
                if not (over > 0).any():
                    break
                try:
                    self.evictor.evict(pod, "quota-overused")
                except EvictionBlocked:
                    continue  # spared; try the next member
                evicted.append(pod.meta.key)
                over = over - pod.spec.requests.to_vector()
        if evicted:
            from koordinator_tpu_torch import manager_metrics

            manager_metrics.QUOTA_REVOKES_TOTAL.inc(len(evicted))
        return evicted
