"""Reservation plugin host side.

Reference `plugins/reservation/`: Reservation CRs are scheduled like pods
(eventhandlers sync them into the cache as fake reservation-pods); Available
reservations pre-claim node resources; pods matching an owner consume reserved
resources (nominator.go picks which one); expired reservations are garbage
collected (controller/controller.go).

Batched shape: the cycle driver schedules Reservation CRs through the same
batched kernel (their template requests ride the pod batch); matching pods are
nominated to their reservation's node host-side BEFORE the kernel pass (the
reference nominator also prefers reservations over open capacity), consuming
from the reservation's free resources. A matched pod bypasses Filter thresholds
the way the reference's reservation-restore transformer returns reserved
resources to the node snapshot."""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np

from koordinator_tpu_torch.api.objects import (
    ANNOTATION_RESERVATION_ALLOCATED,
    Pod,
    Reservation,
)
from koordinator_tpu_torch.client.store import (
    KIND_RESERVATION,
    EventType,
    ObjectStore,
)
from koordinator_tpu_torch.scheduler.frameworkext import (
    CycleContext,
    FilterTransformer,
    Plugin,
)


class ReservationRestoreTransformer(FilterTransformer):
    """Reservation restore through the declared before-Filter extension point
    (reference plugins/reservation/transformer.go BeforeFilter: expand the
    nodeInfo view with reserved resources so owner pods fit).

    Batched form: the base snapshot counts every assigned pod; this transform
    (a) adds each Available reservation's held capacity to its node's
    assigned_requests, and (b) subtracts pods allocated FROM a counted
    reservation, since their usage lives inside the reservation's allocatable
    (double-count restore). Expired/failed reservations are skipped, so their
    consumers fall back to direct accounting and the node never overcommits."""

    name = "ReservationRestore"

    def __init__(self, store: ObjectStore):
        self.store = store

    def before_filter(self, state, ctx: CycleContext) -> None:
        out = state.assigned_requests

        def add(node: str, vec: np.ndarray) -> None:
            if node in out:
                out[node] = out[node] + vec
            else:
                out[node] = vec.astype(np.float32)

        counted = set()
        for res in self.store.list(KIND_RESERVATION):
            if res.is_available and not res.is_expired(ctx.now):
                counted.add(res.meta.name)
                add(res.node_name, res.allocatable.to_vector())
        # pod-backed reservations (operating-mode pods) already occupy their
        # node AS assigned pods — no capacity to add — but their consumers'
        # usage lives inside that footprint, so they join the subtract pass
        for pod in state.pods_by_key.values():
            if (pod.is_reservation_operating_mode and pod.is_assigned
                    and not pod.is_terminated):
                counted.add(f"pod:{pod.meta.key}")
        if not counted:
            return
        from koordinator_tpu_torch.ops.fit import with_pod_count

        for pod in state.pods_by_key.values():
            if not pod.is_assigned or pod.is_terminated:
                continue
            res_name = pod.meta.annotations.get(ANNOTATION_RESERVATION_ALLOCATED)
            if res_name and res_name in counted:
                add(pod.spec.node_name,
                    -with_pod_count(pod.spec.requests.to_vector()[None])[0])


class ReservationPlugin(Plugin):
    name = "Reservation"

    def __init__(self) -> None:
        self.by_name: Dict[str, Reservation] = {}
        self.by_node: Dict[str, List[str]] = {}
        self._store: Optional[ObjectStore] = None
        # (store rv, {reservation name -> [(owner key, requests)]}) — one
        # O(P) pass serves every cold rebuild of a subscriber replay
        self._consumer_index = (-1, {})

    def register(self, store: ObjectStore) -> None:
        self._store = store
        store.subscribe(KIND_RESERVATION, self._on_reservation)
        from koordinator_tpu_torch.client.store import KIND_POD

        store.subscribe(KIND_POD, self._on_pod)

    def _on_pod(self, ev: EventType, pod: Pod, old) -> None:
        """Operating-mode pods (operating_pod.go ReservationPodOperatingMode)
        mirror into the reservation cache once assigned: the pod schedules
        like any pod, then its resources are reserved for its declared
        owners. The pod's lifecycle governs the entry — termination or
        deletion removes it."""
        if not pod.is_reservation_operating_mode:
            return
        key = f"pod:{pod.meta.key}"
        if (ev is EventType.DELETED or pod.is_terminated
                or not pod.is_assigned):
            prev = self.by_name.pop(key, None)
            if prev and prev.node_name:
                nodes = self.by_node.get(prev.node_name, [])
                if key in nodes:
                    nodes.remove(key)
            return
        from dataclasses import replace

        from koordinator_tpu_torch.api.resources import ResourceList

        prev = self.by_name.get(key)
        if prev is not None:
            allocated, owners_now = prev.allocated, prev.current_owners
        else:
            # cold rebuild (subscriber replay / scheduler restart): the
            # consumed amount lives on the CONSUMER pods' annotations —
            # without this, a restarted scheduler would see the full
            # footprint free and over-consume the reservation
            allocated, owners_now = ResourceList(), []
            for owner_key, req in self._consumers_of(key):
                allocated = allocated.add(req)
                owners_now.append(owner_key)
        res = Reservation(
            meta=(prev.meta if prev
                  else replace(pod.meta, name=key, namespace="")),
            owners=pod.reservation_owners(),
            allocate_once=False,
            phase="Available",
            node_name=pod.spec.node_name,
            allocatable=pod.spec.requests.copy(),
            allocated=allocated,
            current_owners=owners_now,
            from_pod_key=pod.meta.key,
        )
        self.by_name[key] = res
        nodes = self.by_node.setdefault(pod.spec.node_name, [])
        if key not in nodes:
            nodes.append(key)

    def _consumers_of(self, res_name: str):
        """Consumers grouped by reservation annotation, indexed once per
        store state (an O(P) scan per operating-mode pod would make
        subscriber replay O(N*P))."""
        if self._store is None:
            return []
        rv = self._store.resource_version
        if self._consumer_index[0] != rv:
            from koordinator_tpu_torch.client.store import KIND_POD

            index: Dict[str, list] = {}
            for other in self._store.list(KIND_POD):
                target = other.meta.annotations.get(
                    ANNOTATION_RESERVATION_ALLOCATED)
                if (target and other.is_assigned
                        and not other.is_terminated):
                    index.setdefault(target, []).append(
                        (other.meta.key, other.spec.requests))
            self._consumer_index = (rv, index)
        return self._consumer_index[1].get(res_name, [])

    def _persist_pod_backed_owners(self, res: Reservation) -> None:
        """Write the owner list onto the BACKING pod
        (operating_pod.go AnnotationReservationCurrentOwner) — the single
        persistence site consume() and unreserve() share."""
        if not res.from_pod_key or self._store is None:
            return
        import json

        from koordinator_tpu_torch.api.objects import (
            ANNOTATION_RESERVATION_CURRENT_OWNER,
        )
        from koordinator_tpu_torch.client.store import KIND_POD

        backing = self._store.get(KIND_POD, res.from_pod_key)
        if backing is not None:
            backing.meta.annotations[
                ANNOTATION_RESERVATION_CURRENT_OWNER
            ] = json.dumps(res.current_owners)
            self._store.update(KIND_POD, backing)

    def _on_reservation(self, ev: EventType, res: Reservation, old) -> None:
        key = res.meta.name
        if ev is EventType.DELETED:
            prev = self.by_name.pop(key, None)
            if prev and prev.node_name:
                nodes = self.by_node.get(prev.node_name, [])
                if key in nodes:
                    nodes.remove(key)
            return
        prev = self.by_name.get(key)
        if prev and prev.node_name and prev.node_name != res.node_name:
            nodes = self.by_node.get(prev.node_name, [])
            if key in nodes:
                nodes.remove(key)
        self.by_name[key] = res
        if res.node_name:
            nodes = self.by_node.setdefault(res.node_name, [])
            if key not in nodes:
                nodes.append(key)

    # -- nomination (nominator.go analog) -----------------------------------
    def nominate(self, pod: Pod, now: float) -> Optional[Reservation]:
        """Pick the matching Available reservation with enough free resources;
        earliest-created wins (deterministic)."""
        candidates = []
        req = pod.spec.requests
        for res in self.by_name.values():
            if not res.is_available or res.is_expired(now):
                continue
            if res.allocate_once and res.current_owners:
                continue
            if not res.matches(pod):
                continue
            free = res.allocatable.sub(res.allocated)
            if any(req[r] > free[r] for r in req):
                continue
            candidates.append(res)
        if not candidates:
            return None
        candidates.sort(key=lambda r: (r.meta.creation_timestamp, r.meta.name))
        return candidates[0]

    def consume(self, pod: Pod, res: Reservation, ctx: CycleContext) -> None:
        res.allocated = res.allocated.add(pod.spec.requests)
        res.current_owners.append(pod.meta.key)
        ctx.data.setdefault("reservation_of", {})[pod.meta.key] = res.meta.name
        if self._store is None:
            return
        if res.from_pod_key:
            self._persist_pod_backed_owners(res)
        else:
            self._store.update(KIND_RESERVATION, res)

    def unreserve(self, pod: Pod, node_name: str, ctx: CycleContext) -> None:
        res_name = ctx.data.get("reservation_of", {}).pop(pod.meta.key, None)
        if res_name and res_name in self.by_name:
            res = self.by_name[res_name]
            res.allocated = res.allocated.sub(pod.spec.requests)
            if pod.meta.key in res.current_owners:
                res.current_owners.remove(pod.meta.key)
            self._persist_pod_backed_owners(res)

    def pre_bind(self, pod: Pod, node_name: str, ctx: CycleContext,
                 annotations: Dict[str, str]) -> None:
        res_name = ctx.data.get("reservation_of", {}).get(pod.meta.key)
        if res_name:
            annotations[ANNOTATION_RESERVATION_ALLOCATED] = res_name

    # -- GC controller (controller/controller.go analog) --------------------
    def expire_reservations(self, now: Optional[float] = None) -> List[str]:
        """Mark expired reservations Failed; returns expired names."""
        now = time.time() if now is None else now
        expired = []
        for res in self.by_name.values():
            if res.from_pod_key:
                continue  # the backing pod's lifecycle governs, never a TTL
            if res.phase in ("Pending", "Available") and res.is_expired(now):
                res.phase = "Failed"
                expired.append(res.meta.name)
                if self._store is not None:
                    self._store.update(KIND_RESERVATION, res)
        return expired


class ReservationController:
    """Expiry + GC controller (plugins/reservation/controller/controller.go):
    each reconcile pass expires overdue Pending/Available reservations (via
    the plugin, which owns the cache), marks fully-allocated allocate-once
    reservations Succeeded, and deletes terminal (Failed/Succeeded)
    reservations once they have been terminal for gc_duration_seconds."""

    def __init__(self, plugin: ReservationPlugin, store: ObjectStore,
                 gc_duration_seconds: float = 24 * 3600.0):
        self.plugin = plugin
        self.store = store
        self.gc_duration = gc_duration_seconds
        self._terminal_since: Dict[str, float] = {}

    def reconcile(self, now: Optional[float] = None) -> Dict[str, List[str]]:
        now = time.time() if now is None else now
        expired = self.plugin.expire_reservations(now)
        succeeded: List[str] = []
        deleted: List[str] = []
        for res in list(self.plugin.by_name.values()):
            # allocate-once reservations that have been consumed are done
            if (res.phase == "Available" and res.allocate_once
                    and res.current_owners):
                res.phase = "Succeeded"
                succeeded.append(res.meta.name)
                self.store.update(KIND_RESERVATION, res)
            if res.phase in ("Failed", "Succeeded"):
                since = self._terminal_since.setdefault(res.meta.name, now)
                if now - since >= self.gc_duration:
                    self.store.delete(KIND_RESERVATION, res.meta.key)
                    self._terminal_since.pop(res.meta.name, None)
                    deleted.append(res.meta.name)
            else:
                self._terminal_since.pop(res.meta.name, None)
        return {"expired": expired, "succeeded": succeeded, "deleted": deleted}
