"""Vendored-style descheduler plugins, implemented natively.

Reference routes these through the sigs.k8s.io/descheduler adaptor
(`pkg/descheduler/framework/plugins/kubernetes/plugin.go:60-`); here they run
directly against the ObjectStore through the profile Handle's
Filter -> PreEvictionFilter -> Evict chain.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, List

from koordinator_tpu_torch.api.objects import Node, Pod
from koordinator_tpu_torch.client.store import KIND_POD, ObjectStore
from koordinator_tpu_torch.descheduler.framework import (
    BalancePlugin,
    DeschedulePlugin,
    Status,
    register_plugin,
)


def _live_assigned(store: ObjectStore) -> List[Pod]:
    return [
        p for p in store.list(KIND_POD)
        if p.is_assigned and not p.is_terminated
    ]


def node_matches_pod(node: Node, pod: Pod) -> bool:
    """nodeSelector + required node affinity against current node labels
    (nodeaffinity.go utils.PodMatchesNodeSelectorAndAffinityTerms)."""
    for k, v in pod.spec.node_selector.items():
        if node.meta.labels.get(k) != v:
            return False
    for k, v in pod.spec.affinity_required_node_labels.items():
        if node.meta.labels.get(k) != v:
            return False
    return True


class RemovePodsViolatingNodeAffinity(DeschedulePlugin):
    """Evict pods whose node no longer satisfies their required node
    affinity/selector (sigs.k8s.io removepodsviolatingnodeaffinity:
    requiredDuringSchedulingIgnoredDuringExecution re-checked at runtime).
    Only evicts when some OTHER node currently matches, so the pod has
    somewhere to go (the upstream feasibility pre-check)."""

    name = "RemovePodsViolatingNodeAffinity"

    def __init__(self, store: ObjectStore, args: dict = None) -> None:
        self.store = store
        self.handle = None  # injected by Profile

    def deschedule(self, nodes: List[Node], now: float) -> Status:
        by_name = {n.meta.name: n for n in nodes}
        for pod in _live_assigned(self.store):
            if not pod.spec.node_selector and \
                    not pod.spec.affinity_required_node_labels:
                continue
            node = by_name.get(pod.spec.node_name)
            if node is None or node_matches_pod(node, pod):
                continue
            if not any(
                node_matches_pod(n, pod)
                for n in nodes
                if n.meta.name != pod.spec.node_name and not n.unschedulable
            ):
                continue  # nowhere to go; leave it running
            self.handle.evict(pod, self.name, "node affinity violated")
        return Status()


class RemoveDuplicates(BalancePlugin):
    """Spread duplicate workload replicas: when one node runs more than one
    replica of the same controller and spare nodes exist, evict the extras so
    the scheduler can spread them (sigs.k8s.io removeduplicates)."""

    name = "RemoveDuplicates"

    def __init__(self, store: ObjectStore, args: dict = None) -> None:
        self.store = store
        self.handle = None

    def balance(self, nodes: List[Node], now: float) -> Status:
        schedulable = [n for n in nodes if not n.unschedulable]
        if len(schedulable) < 2:
            return Status()
        # (namespace, owner) -> node -> replicas
        groups: Dict[tuple, Dict[str, List[Pod]]] = defaultdict(
            lambda: defaultdict(list)
        )
        for pod in _live_assigned(self.store):
            if not pod.meta.owner_kind or not pod.meta.owner_name:
                continue
            key = (pod.meta.namespace, pod.meta.owner_kind, pod.meta.owner_name)
            groups[key][pod.spec.node_name].append(pod)
        for key, by_node in groups.items():
            for node_name, replicas in by_node.items():
                if len(replicas) <= 1:
                    continue
                # keep the oldest replica; evict the rest (upstream keeps one
                # per node and lets the scheduler respread) — but only when
                # some OTHER schedulable node can host the pod, else the
                # evict/reschedule-back loop churns the workload forever
                replicas.sort(key=lambda p: p.meta.creation_timestamp)
                for pod in replicas[1:]:
                    if not any(
                        n.meta.name != node_name and node_matches_pod(n, pod)
                        for n in schedulable
                    ):
                        continue
                    self.handle.evict(pod, self.name, "duplicate replica")
        return Status()


class PodLifeTime(DeschedulePlugin):
    """Evict pods older than maxPodLifeTimeSeconds, optionally restricted to
    pod phases (sigs.k8s.io podlifetime: PodLifeTimeArgs.MaxPodLifeTimeSeconds
    + States)."""

    name = "PodLifeTime"

    def __init__(self, store: ObjectStore, args: dict = None) -> None:
        args = args or {}
        if "maxPodLifeTimeSeconds" not in args:
            # upstream validation treats the parameter as required; a silent
            # default would start evicting cluster-wide on an empty config
            raise ValueError("PodLifeTime requires maxPodLifeTimeSeconds")
        self.store = store
        self.handle = None
        self.max_seconds = float(args["maxPodLifeTimeSeconds"])
        self.states = set(args.get("states", []))  # empty = any phase

    def deschedule(self, nodes: List[Node], now: float) -> Status:
        for pod in _live_assigned(self.store):
            if self.states and pod.phase not in self.states:
                continue
            age = now - pod.meta.creation_timestamp
            if age > self.max_seconds:
                self.handle.evict(
                    pod, self.name,
                    f"pod lifetime {age:.0f}s exceeds {self.max_seconds:.0f}s",
                )
        return Status()


class RemoveFailedPods(DeschedulePlugin):
    """Evict Failed pods so their controllers can recreate them fresh
    (sigs.k8s.io removefailedpods: reasons filter, minPodLifetimeSeconds,
    excludeOwnerKinds)."""

    name = "RemoveFailedPods"

    def __init__(self, store: ObjectStore, args: dict = None) -> None:
        args = args or {}
        self.store = store
        self.handle = None
        self.reasons = set(args.get("reasons", []))  # empty = any reason
        self.min_lifetime = float(args.get("minPodLifetimeSeconds", 0))
        self.exclude_owner_kinds = set(args.get("excludeOwnerKinds", []))
        # upstream defaultevictor EvictFailedBarePods: bare failed pods have
        # no controller to recreate them, so deleting destroys the failure
        # record — opt-in only
        self.evict_failed_bare_pods = bool(args.get("evictFailedBarePods",
                                                    False))

    def deschedule(self, nodes: List[Node], now: float) -> Status:
        for pod in self.store.list(KIND_POD):
            if pod.phase != "Failed" or not pod.is_assigned:
                continue
            if self.reasons and pod.reason not in self.reasons:
                continue
            if pod.meta.owner_kind in self.exclude_owner_kinds:
                continue
            if now - pod.meta.creation_timestamp < self.min_lifetime:
                continue
            # a Failed pod is already terminated, which the evictor chain
            # categorically refuses — but every OTHER evictability guard
            # (opt-out annotation, DaemonSet, system-critical priority, any
            # profile-configured FilterPlugins) still applies: run the full
            # chain on a view with the phase neutralized, then delete
            # (upstream's eviction of a failed pod IS deletion)
            from koordinator_tpu_torch.descheduler.evictions import (
                ANNOTATION_EVICTABLE,
            )

            if pod.meta.annotations.get(ANNOTATION_EVICTABLE) == "false":
                continue  # explicit opt-out holds even without a Profile
            if not pod.meta.owner_kind:
                if not self.evict_failed_bare_pods:
                    continue
                # EvictFailedBarePods waives ONLY the bare-pod rule: fake an
                # owner on the view so the rest of the chain still runs
                view_meta = dataclasses.replace(
                    pod.meta, owner_kind="__evict-failed-bare__"
                )
            else:
                view_meta = pod.meta
            view = dataclasses.replace(pod, phase="Running", meta=view_meta)
            if self.handle is not None and not self.handle.filter(view):
                continue
            self.store.delete(KIND_POD, pod.meta.key)
            if self.handle is not None:
                self.handle.evicted_count += 1
        return Status()


class RemovePodsHavingTooManyRestarts(DeschedulePlugin):
    """Evict crash-looping pods past a restart threshold (sigs.k8s.io
    removepodshavingtoomanyrestarts: PodRestartThreshold)."""

    name = "RemovePodsHavingTooManyRestarts"

    def __init__(self, store: ObjectStore, args: dict = None) -> None:
        args = args or {}
        self.store = store
        self.handle = None
        self.threshold = int(args.get("podRestartThreshold", 100))

    def deschedule(self, nodes: List[Node], now: float) -> Status:
        for pod in _live_assigned(self.store):
            if pod.restart_count >= self.threshold:
                self.handle.evict(
                    pod, self.name,
                    f"{pod.restart_count} restarts >= {self.threshold}",
                )
        return Status()


class RemovePodsViolatingNodeTaints(DeschedulePlugin):
    """Evict pods that no longer tolerate their node's taints (sigs.k8s.io
    removepodsviolatingnodetaints; taints carry NoSchedule semantics in this
    model)."""

    name = "RemovePodsViolatingNodeTaints"

    def __init__(self, store: ObjectStore, args: dict = None) -> None:
        self.store = store
        self.handle = None

    @staticmethod
    def _tolerates(pod: Pod, node: Node) -> bool:
        from koordinator_tpu_torch.ops.taints import tolerates_taints

        return tolerates_taints(pod.spec.tolerations, node.taints)

    def deschedule(self, nodes: List[Node], now: float) -> Status:
        by_name = {n.meta.name: n for n in nodes}
        for pod in _live_assigned(self.store):
            node = by_name.get(pod.spec.node_name)
            if node is None or not node.taints:
                continue
            if self._tolerates(pod, node):
                continue
            # feasibility pre-check (same guard as the affinity/duplicates
            # plugins): evict only when some OTHER schedulable node could
            # host the pod, else the evict/reschedule-back loop churns it
            if not any(
                n.meta.name != pod.spec.node_name
                and not n.unschedulable
                and self._tolerates(pod, n)
                and node_matches_pod(n, pod)
                for n in nodes
            ):
                continue
            self.handle.evict(pod, self.name, "node taints not tolerated")
        return Status()


class RemovePodsViolatingInterPodAntiAffinity(DeschedulePlugin):
    """Evict pods whose required anti-affinity terms are violated by a
    co-located pod in the same topology domain (sigs.k8s.io
    removepodsviolatinginterpodantiaffinity). Runtime violations appear when
    pods were placed before the constraint existed or labels changed."""

    name = "RemovePodsViolatingInterPodAntiAffinity"

    def __init__(self, store: ObjectStore, args: dict = None) -> None:
        self.store = store
        self.handle = None

    def deschedule(self, nodes: List[Node], now: float) -> Status:
        from koordinator_tpu_torch.ops.podaffinity import _pod_matches, _term_key

        by_name = {n.meta.name: n for n in nodes}
        live = _live_assigned(self.store)
        evicted: set = set()
        for pod in live:
            if not pod.spec.pod_anti_affinity or pod.meta.key in evicted:
                continue
            node = by_name.get(pod.spec.node_name)
            if node is None:
                continue
            violated = False
            for raw in pod.spec.pod_anti_affinity:
                term = _term_key(raw, pod)
                dom = node.meta.labels.get(raw.topology_key)
                if dom is None:
                    continue
                for other in live:
                    # pods evicted earlier in this pass no longer violate —
                    # evicting ONE of a mutually-violating pair resolves it
                    if other.meta.key == pod.meta.key or \
                            other.meta.key in evicted:
                        continue
                    other_node = by_name.get(other.spec.node_name)
                    if other_node is None or \
                            other_node.meta.labels.get(
                                raw.topology_key) != dom:
                        continue
                    if _pod_matches(term, other):
                        violated = True
                        break
                if violated:
                    break
            if violated and self.handle.evict(
                    pod, self.name, "anti-affinity violated"):
                evicted.add(pod.meta.key)
        return Status()


class RemovePodsViolatingTopologySpreadConstraint(BalancePlugin):
    """Evict pods from over-populated topology domains until every
    DoNotSchedule spread constraint's skew fits maxSkew again
    (sigs.k8s.io removepodsviolatingtopologyspreadconstraint)."""

    name = "RemovePodsViolatingTopologySpreadConstraint"

    def __init__(self, store: ObjectStore, args: dict = None) -> None:
        self.store = store
        self.handle = None

    def balance(self, nodes: List[Node], now: float) -> Status:
        from koordinator_tpu_torch.ops.podaffinity import _pod_matches, _spread_key

        by_name = {n.meta.name: n for n in nodes}
        live = _live_assigned(self.store)
        # group constraints by (term identity, maxSkew): all pods carrying
        # the same constraint share one skew computation
        carriers: Dict[tuple, List[Pod]] = defaultdict(list)
        for pod in live:
            for con in pod.spec.topology_spread:
                # ScheduleAnyway is advisory scoring — the scheduler may
                # legitimately exceed its skew; enforcing it here would
                # evict/re-place in a loop (upstream includeSoftConstraints
                # defaults to false)
                if con.when_unsatisfiable == "ScheduleAnyway":
                    continue
                carriers[(_spread_key(con, pod), int(con.max_skew))].append(
                    pod)
        for (term, max_skew), constrained in carriers.items():
            topology_key = term[2]
            # a domain counts toward the minimum only if a SCHEDULABLE node
            # in it could host one of the constrained pods — the same
            # eligibility stance the scheduler's spread filter takes, so
            # the two sides can never evict/re-place in a loop (a forbidden
            # or fully-cordoned zone cannot pin the minimum at 0)
            domains: Dict[str, List[Pod]] = {}
            for n in nodes:
                val = n.meta.labels.get(topology_key)
                if val is None or n.unschedulable:
                    continue
                if any(node_matches_pod(n, p) for p in constrained):
                    domains.setdefault(val, [])
            if not domains:
                continue
            for other in live:
                node = by_name.get(other.spec.node_name)
                if node is None:
                    continue
                val = node.meta.labels.get(topology_key)
                if val in domains and _pod_matches(term, other):
                    domains[val].append(other)
            counts = {d: len(ps) for d, ps in domains.items()}
            min_count = min(counts.values())
            for dom, pods_in in sorted(domains.items()):
                excess = counts[dom] - (min_count + max_skew)
                if excess <= 0:
                    continue
                victims = sorted(
                    pods_in, key=lambda p: p.meta.creation_timestamp,
                    reverse=True)[:excess]
                for pod in victims:
                    self.handle.evict(
                        pod, self.name,
                        f"topology skew {counts[dom] - min_count} > "
                        f"maxSkew {max_skew} in {topology_key}={dom}")
        return Status()


class HighNodeUtilization(BalancePlugin):
    """Bin-packing consolidation: evict movable pods from UNDER-utilized
    nodes so the cluster can be compacted (sigs.k8s.io
    highnodeutilization — the inverse of LowNodeLoad's spreading)."""

    name = "HighNodeUtilization"

    def __init__(self, store: ObjectStore, args: dict = None) -> None:
        self.store = store
        self.args = args or {}
        self.handle = None

    def balance(self, nodes: List[Node], now: float) -> Status:
        from koordinator_tpu_torch.client.store import KIND_NODE_METRIC

        threshold = float(self.args.get("cpu_threshold_percent", 20))
        under = []
        for node in nodes:
            if node.unschedulable:
                continue
            nm = self.store.get(KIND_NODE_METRIC, f"/{node.meta.name}")
            if nm is None:
                continue
            cap = node.allocatable.get("cpu", 0)
            used = nm.node_metric.node_usage.get("cpu")
            if cap and used is not None and used * 100.0 / cap < threshold:
                under.append(node)
        schedulable = [n for n in nodes if not n.unschedulable]
        if len(under) < 1 or len(under) == len(schedulable):
            return Status()  # nothing to consolidate onto
        under_names = {n.meta.name for n in under}
        # absorb budget: spare cpu on the nodes pods would consolidate onto
        # (upstream stops when target capacity runs out — evicting more
        # than fits would churn: the scheduler puts the rest back)
        requested_by_node: Dict[str, int] = defaultdict(int)
        live = _live_assigned(self.store)
        for pod in live:
            requested_by_node[pod.spec.node_name] += \
                pod.spec.requests.get("cpu", 0)
        spare = sum(
            max(n.allocatable.get("cpu", 0)
                - requested_by_node[n.meta.name], 0)
            for n in schedulable if n.meta.name not in under_names
        )
        for pod in live:
            if pod.spec.node_name not in under_names:
                continue
            need = pod.spec.requests.get("cpu", 0)
            if need > spare:
                continue
            if self.handle.evict(
                    pod, self.name, "under-utilized node consolidation"):
                spare -= need
        return Status()


def register_defaults() -> None:
    """Install the built-in plugin set into the framework registry."""
    from koordinator_tpu_torch.descheduler.framework import DefaultEvictor
    from koordinator_tpu_torch.descheduler.lownodeload import (
        LowNodeLoad,
        LowNodeLoadArgs,
    )

    register_plugin("DefaultEvictor", lambda store, args: DefaultEvictor(store))
    register_plugin(
        "RemovePodsViolatingNodeAffinity",
        lambda store, args: RemovePodsViolatingNodeAffinity(store, args),
    )
    register_plugin(
        "RemoveDuplicates", lambda store, args: RemoveDuplicates(store, args)
    )
    register_plugin(
        "PodLifeTime", lambda store, args: PodLifeTime(store, args)
    )
    register_plugin(
        "RemoveFailedPods", lambda store, args: RemoveFailedPods(store, args)
    )
    register_plugin(
        "RemovePodsHavingTooManyRestarts",
        lambda store, args: RemovePodsHavingTooManyRestarts(store, args),
    )
    register_plugin(
        "RemovePodsViolatingNodeTaints",
        lambda store, args: RemovePodsViolatingNodeTaints(store, args),
    )
    register_plugin(
        "RemovePodsViolatingInterPodAntiAffinity",
        lambda store, args: RemovePodsViolatingInterPodAntiAffinity(
            store, args),
    )
    register_plugin(
        "RemovePodsViolatingTopologySpreadConstraint",
        lambda store, args: RemovePodsViolatingTopologySpreadConstraint(
            store, args),
    )
    register_plugin(
        "HighNodeUtilization",
        lambda store, args: HighNodeUtilization(store, args),
    )
    register_plugin(
        "LowNodeLoad",
        lambda store, args: _LowNodeLoadAdapter(
            store, LowNodeLoadArgs(**args) if args else None
        ),
    )


class _LowNodeLoadAdapter(BalancePlugin):
    """BalancePlugin facade over the batched LowNodeLoad classifier (it
    creates PodMigrationJob CRs; the migration controller evicts).
    ``enabled`` is the KOORD_TPU_REBALANCE=off kill switch (the
    Descheduler wires it); the other plugins keep running."""

    name = "LowNodeLoad"

    def __init__(self, store: ObjectStore, args=None) -> None:
        from koordinator_tpu_torch.descheduler.lownodeload import LowNodeLoad

        self.inner = LowNodeLoad(store, args)
        self.handle = None
        self.enabled = True

    def balance(self, nodes, now: float) -> Status:
        if not self.enabled:
            return Status()
        self.inner.balance(now)
        return Status()


register_defaults()
