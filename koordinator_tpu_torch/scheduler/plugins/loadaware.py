"""LoadAware plugin host side: the podAssignCache.

Reference `plugins/loadaware/pod_assign_cache.go`: tracks pods Reserved on each
node with their assign timestamp, so Score can estimate usage of pods not yet
visible in NodeMetric. Maintained from store events (Reserve adds, terminal
phase/delete removes)."""

from __future__ import annotations

import time
from typing import Dict, List, Tuple

from koordinator_tpu_torch.api.objects import Pod
from koordinator_tpu_torch.client.store import KIND_POD, EventType, ObjectStore
from koordinator_tpu_torch.scheduler.frameworkext import CycleContext, Plugin


class LoadAwarePlugin(Plugin):
    name = "LoadAwareScheduling"

    def __init__(self) -> None:
        self.assign_cache: Dict[str, Dict[str, Tuple[Pod, float]]] = {}
        # per-node change counter: bumped on EVERY mutation of the node's
        # assign-cache entry set, so the incremental snapshot builder
        # (scheduler/snapshot_cache.py) can key its per-node LoadAware rows
        self.node_epoch: Dict[str, int] = {}
        # names bumped since the snapshot cache last drained: lets the
        # cache find changed nodes without scanning every epoch per build
        self.epoch_dirty: set = set()

    def _bump(self, node_name: str) -> None:
        self.node_epoch[node_name] = self.node_epoch.get(node_name, 0) + 1
        self.epoch_dirty.add(node_name)

    def register(self, store: ObjectStore) -> None:
        store.subscribe(KIND_POD, self._on_pod)

    def _on_pod(self, ev: EventType, pod: Pod, old) -> None:
        if ev in (EventType.ADDED, EventType.MODIFIED):
            if pod.is_assigned and not pod.is_terminated:
                node = self.assign_cache.setdefault(pod.spec.node_name, {})
                if pod.meta.key not in node:
                    node[pod.meta.key] = (pod, time.time())
                else:
                    node[pod.meta.key] = (pod, node[pod.meta.key][1])
                self._bump(pod.spec.node_name)
            elif pod.is_terminated:
                self._drop(pod)
        elif ev is EventType.DELETED:
            self._drop(pod)

    def _drop(self, pod: Pod) -> None:
        node = self.assign_cache.get(pod.spec.node_name)
        if node:
            node.pop(pod.meta.key, None)
            self._bump(pod.spec.node_name)

    def reserve(self, pod: Pod, node_name: str, ctx: CycleContext):
        self.assign_cache.setdefault(node_name, {})[pod.meta.key] = (pod, ctx.now)
        self._bump(node_name)
        return None

    def unreserve(self, pod: Pod, node_name: str, ctx: CycleContext) -> None:
        node = self.assign_cache.get(node_name)
        if node:
            node.pop(pod.meta.key, None)
            self._bump(node_name)

    def assigned_view(self) -> Dict[str, List[Tuple[Pod, float]]]:
        return {
            node: list(items.values()) for node, items in self.assign_cache.items()
        }
