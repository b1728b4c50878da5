"""Migration controller + arbitrator.

Analog of reference `pkg/descheduler/controllers/migration/`:
  * Arbitrator (arbitrator/arbitrator.go:46-200): sorts pending jobs (creation
    time) and filters by blast-radius rate limits — max concurrent migrations
    per node / namespace / workload owner.
  * Reconciler (controller.go:241-383): per job, ReservationFirst mode creates
    a Reservation for the victim's replacement, waits for it to be scheduled
    (Available), then evicts the victim; EvictDirectly skips the reserve leg.
    Jobs expire after their TTL.
"""

from __future__ import annotations

import math

import time
from dataclasses import dataclass
from typing import Dict, List, Optional

from koordinator_tpu_torch.api.objects import (
    ObjectMeta,
    Pod,
    PodMigrationJob,
    PodSpec,
    Reservation,
    ReservationOwner,
)
from koordinator_tpu_torch.client.store import (
    KIND_POD,
    KIND_POD_MIGRATION_JOB,
    KIND_RESERVATION,
    ObjectStore,
)


@dataclass
class ArbitratorArgs:
    max_migrating_per_node: int = 2
    max_migrating_per_namespace: int = 10
    max_migrating_per_workload: int = 1


class Arbitrator:
    def __init__(self, store: ObjectStore, args: Optional[ArbitratorArgs] = None):
        self.store = store
        self.args = args or ArbitratorArgs()

    def arbitrate(self, jobs: List[PodMigrationJob]) -> List[PodMigrationJob]:
        """Sort + rate-limit filter; returns the admitted subset in order."""
        running = [
            j for j in self.store.list(KIND_POD_MIGRATION_JOB)
            if j.phase == "Running"
        ]
        per_node: Dict[str, int] = {}
        per_ns: Dict[str, int] = {}
        per_workload: Dict[str, int] = {}

        def pod_of(job: PodMigrationJob) -> Optional[Pod]:
            return self.store.get(KIND_POD, f"{job.pod_namespace}/{job.pod_name}")

        for j in running:
            pod = pod_of(j)
            if pod is None:
                continue
            per_node[pod.spec.node_name] = per_node.get(pod.spec.node_name, 0) + 1
            per_ns[pod.meta.namespace] = per_ns.get(pod.meta.namespace, 0) + 1
            wl = f"{pod.meta.owner_kind}/{pod.meta.owner_name}"
            per_workload[wl] = per_workload.get(wl, 0) + 1

        def eviction_cost(pod: Optional[Pod]) -> int:
            """scheduling.koordinator.sh/eviction-cost (descheduling.go):
            cheaper pods migrate first; int32-max opts the pod out entirely
            (FilterPodWithMaxEvictionCost); malformed values cost 0."""
            if pod is None:
                return 0
            raw = pod.meta.annotations.get(
                "scheduling.koordinator.sh/eviction-cost")
            if raw is None:
                return 0
            try:
                value = float(raw)
                if not math.isfinite(value):
                    return 0
                return int(value)
            except (TypeError, ValueError):
                return 0

        MAX_INT32 = 2**31 - 1
        # one (cost, pod) lookup per job: the sort key, the opt-out check,
        # and the admission loop all read it
        job_info = {id(j): (eviction_cost(pod_of(j)), pod_of(j))
                    for j in jobs}
        admitted: List[PodMigrationJob] = []
        for job in sorted(jobs, key=lambda j: (job_info[id(j)][0],
                                               j.meta.creation_timestamp,
                                               j.meta.key)):
            cost, pod = job_info[id(job)]
            if cost >= MAX_INT32:
                continue  # opted out of migration
            if pod is None or not pod.is_assigned or pod.is_terminated:
                continue
            node = pod.spec.node_name
            ns = pod.meta.namespace
            wl = f"{pod.meta.owner_kind}/{pod.meta.owner_name}"
            if per_node.get(node, 0) >= self.args.max_migrating_per_node:
                continue
            if per_ns.get(ns, 0) >= self.args.max_migrating_per_namespace:
                continue
            if pod.meta.owner_kind and per_workload.get(wl, 0) >= self.args.max_migrating_per_workload:
                continue
            per_node[node] = per_node.get(node, 0) + 1
            per_ns[ns] = per_ns.get(ns, 0) + 1
            per_workload[wl] = per_workload.get(wl, 0) + 1
            admitted.append(job)
        return admitted


class MigrationController:
    def __init__(self, store: ObjectStore, arbitrator: Optional[Arbitrator] = None,
                 evictor: Optional[object] = None):
        from koordinator_tpu_torch.descheduler.evictions import (
            ControllerFinder,
            EvictionAPIEvictor,
        )

        self.store = store
        self.arbitrator = arbitrator or Arbitrator(store)
        self.evictor = evictor or EvictionAPIEvictor(store)
        self.finder = ControllerFinder(store)

    def reconcile(self, now: Optional[float] = None) -> int:
        """One pass over migration jobs; returns state transitions."""
        now = time.time() if now is None else now
        changes = 0
        pending = [
            j for j in self.store.list(KIND_POD_MIGRATION_JOB)
            if j.phase == "Pending"
        ]
        for job in self.arbitrator.arbitrate(pending):
            job.phase = "Running"
            self.store.update(KIND_POD_MIGRATION_JOB, job)
            changes += 1

        for job in self.store.list(KIND_POD_MIGRATION_JOB):
            if job.phase != "Running":
                continue
            if now - job.meta.creation_timestamp > job.ttl_seconds:
                changes += self._fail(job, "timeout")
                continue
            pod = self.store.get(KIND_POD, f"{job.pod_namespace}/{job.pod_name}")
            if pod is None or pod.is_terminated:
                job.phase = "Succeeded"
                self.store.update(KIND_POD_MIGRATION_JOB, job)
                changes += 1
                continue
            if not pod.is_assigned:
                # pod fell back to pending (binding rolled back): wait without
                # rewriting the unchanged job every pass
                continue
            if job.mode == "ReservationFirst":
                changes += self._reserve_then_evict(job, pod, now)
            else:
                changes += self._finish_with_eviction(job, pod)
        return changes

    def _finish_with_eviction(self, job: PodMigrationJob, pod: Pod) -> int:
        """Evict through the configured evictor; a blocked eviction fails the
        job with the block reason (PDB violation, non-evictable pod)."""
        from koordinator_tpu_torch.descheduler.evictions import EvictionBlocked

        # single-replica workload guard (controllerfinder): evicting the only
        # healthy member would take the workload to zero
        workload = self.finder.workload_of(pod)
        if workload.workload and workload.healthy <= 1:
            return self._fail(job, "workload has a single healthy replica")
        try:
            self.evictor.evict(pod, f"migration/{job.meta.name}")
        except EvictionBlocked as e:
            return self._fail(job, str(e))
        job.phase = "Succeeded"
        self.store.update(KIND_POD_MIGRATION_JOB, job)
        return 1

    def _fail(self, job: PodMigrationJob, message: str) -> int:
        """Fail the job, releasing its replacement reservation if one was
        created (the reference controller aborts the reservation with the
        job; leaving it Available would strand owner-locked capacity)."""
        if job.reservation_name:
            self.store.delete(KIND_RESERVATION, f"/{job.reservation_name}")
        job.phase = "Failed"
        job.message = message
        self.store.update(KIND_POD_MIGRATION_JOB, job)
        return 1

    def _reserve_then_evict(self, job: PodMigrationJob, pod: Pod, now: float) -> int:
        from koordinator_tpu_torch.api.objects import ANNOTATION_DECISION_ID

        if not job.reservation_name:
            # create the replacement reservation (controller.go:763-846).
            # koordwatch: the job's decision id rides onto the
            # Reservation, so the scheduler-side consumption of the
            # migration (nomination pre-pass) joins back to the
            # rebalance window that decided it.
            decision_id = job.meta.annotations.get(ANNOTATION_DECISION_ID)
            res = Reservation(
                meta=ObjectMeta(
                    name=f"migrate-{pod.meta.namespace}-{pod.meta.name}",
                    namespace="",
                    creation_timestamp=now,
                    annotations=(
                        {ANNOTATION_DECISION_ID: decision_id}
                        if decision_id else {}),
                ),
                template=PodSpec(
                    priority=pod.spec.priority,
                    requests=pod.spec.requests.copy(),
                ),
                owners=[
                    ReservationOwner(
                        controller_kind=pod.meta.owner_kind,
                        controller_name=pod.meta.owner_name,
                        namespace=pod.meta.namespace,
                    )
                    if pod.meta.owner_kind
                    else ReservationOwner(label_selector=dict(pod.meta.labels))
                ],
                ttl_seconds=job.ttl_seconds,
            )
            if self.store.get(KIND_RESERVATION, res.meta.key) is None:
                self.store.add(KIND_RESERVATION, res)
            job.reservation_name = res.meta.name
            self.store.update(KIND_POD_MIGRATION_JOB, job)
            return 1
        res = self.store.get(KIND_RESERVATION, f"/{job.reservation_name}")
        if res is None or res.phase == "Failed":
            return self._fail(job, "reservation failed or lost")
        if res.phase == "Succeeded" and res.node_name:
            # the allocate-once reservation was already consumed by an
            # owner-matched replica (another pod of the same workload
            # took the reserved spot first): the workload holds the
            # replacement capacity, so the migration completes with the
            # eviction — waiting would only wedge the job until its TTL
            if res.node_name == pod.spec.node_name:
                return self._fail(job,
                                  "reservation landed on the source node")
            return self._finish_with_eviction(job, pod)
        if not res.is_available:
            return 0  # wait for the scheduler to bind the reservation
        # replacement capacity secured away from the source -> evict
        if res.node_name == pod.spec.node_name:
            return self._fail(job, "reservation landed on the source node")
        return self._finish_with_eviction(job, pod)
