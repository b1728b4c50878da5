"""Eviction machinery: controllerfinder, evictability filter, PDB-aware
evictor variants.

Analog of reference `pkg/descheduler/evictions/` +
`controllers/migration/evictor/` + `controllers/migration/controllerfinder/`:

  * ControllerFinder — resolve a pod's workload (owner kind/name) to its
    replica set: expected replicas (from the workload's pods themselves; the
    store carries no Deployment objects) and currently-healthy members.
  * is_evictable — defaultevictor filter semantics: DaemonSet pods, bare
    (ownerless) pods, and system-critical-priority pods are non-evictable
    unless force-annotated; an explicit opt-out annotation always wins.
  * PDB check — policy/v1 semantics on the healthy member count.
  * Evictor variants (migration/evictor/): EvictionAPIEvictor (the default —
    honors PDBs and evictability), DeleteEvictor (direct delete, still honors
    evictability but skips PDBs, the reference's "delete" mode), SoftEvictor
    (annotate only; koordlet acts on the annotation later).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from koordinator_tpu_torch.api.objects import Pod, PodDisruptionBudget
from koordinator_tpu_torch.client.store import KIND_PDB, KIND_POD, ObjectStore

# annotations (apis/extension eviction semantics)
ANNOTATION_EVICTABLE = "descheduler.koordinator.sh/evictable"  # "true"/"false"
ANNOTATION_SOFT_EVICTION = "scheduling.koordinator.sh/soft-eviction"
SYSTEM_CRITICAL_PRIORITY = 2_000_000_000  # system-cluster-critical floor


class EvictionBlocked(Exception):
    """Eviction refused; str(exc) carries the reason."""


@dataclass
class WorkloadReplicas:
    workload: str               # "Kind/name" ("" for bare pods)
    members: List[Pod]
    healthy: int                # live members (not terminated)

    @property
    def replicas(self) -> int:
        return len(self.members)


class ControllerFinder:
    """controllerfinder/: map pod -> workload replica set via owner refs."""

    def __init__(self, store: ObjectStore):
        self.store = store

    def workload_of(self, pod: Pod) -> WorkloadReplicas:
        if not pod.meta.owner_kind:
            live = 0 if pod.is_terminated else 1
            return WorkloadReplicas("", [pod], live)
        members = [
            p for p in self.store.list(KIND_POD)
            if p.meta.namespace == pod.meta.namespace
            and p.meta.owner_kind == pod.meta.owner_kind
            and p.meta.owner_name == pod.meta.owner_name
        ]
        healthy = sum(1 for p in members if not p.is_terminated)
        return WorkloadReplicas(
            f"{pod.meta.owner_kind}/{pod.meta.owner_name}", members, healthy)


def terminate_pod(store: ObjectStore, pod: Pod, annotation: str,
                  reason: str) -> Pod:
    """Mark a pod Failed through the store, via a COPY: the store holds live
    references, so mutating the stored object in place would make the MODIFIED
    event's old==new and hide the phase transition from subscribers (quota
    used rollback, assign caches). Single home for that invariant — eviction
    and preemption both route here."""
    updated = pod.patch_copy()
    updated.phase = "Failed"
    updated.meta.annotations[annotation] = reason
    store.update(KIND_POD, updated)
    return updated


def is_evictable(pod: Pod) -> Tuple[bool, str]:
    """(ok, reason). defaultevictor filter chain. A terminated pod is never
    evictable — that check precedes even the force annotation."""
    if pod.is_terminated:
        return False, "pod already terminated"
    ann = pod.meta.annotations.get(ANNOTATION_EVICTABLE)
    if ann == "false":
        return False, "eviction disabled by annotation"
    if ann == "true":
        return True, ""
    if pod.meta.owner_kind == "DaemonSet":
        return False, "daemonset pod"
    if not pod.meta.owner_kind:
        return False, "bare pod without a controller"
    if (pod.spec.priority or 0) >= SYSTEM_CRITICAL_PRIORITY:
        return False, "system critical priority"
    return True, ""


def check_pdbs(store: ObjectStore, pod: Pod) -> Optional[str]:
    """Violated-PDB reason, or None if eviction is allowed. policy/v1: after
    the eviction the matching pods' healthy count must stay >= minAvailable
    (and the unavailable count <= maxUnavailable)."""
    pdbs: List[PodDisruptionBudget] = [
        pdb for pdb in store.list(KIND_PDB) if pdb.matches(pod)
    ]
    if not pdbs:
        return None
    # evicting an already-unhealthy pod consumes no budget: the healthy
    # count does not drop and the unavailable count does not grow
    cost = 1 if pod.is_healthy else 0
    for pdb in pdbs:
        matching = [p for p in store.list(KIND_POD) if pdb.matches(p)]
        healthy = sum(1 for p in matching if p.is_healthy)
        if (pdb.min_available is not None
                and healthy - cost < pdb.min_available):
            return (f"pdb {pdb.meta.key}: healthy {healthy}-{cost} < "
                    f"minAvailable {pdb.min_available}")
        if pdb.max_unavailable is not None:
            unavailable = len(matching) - healthy
            if unavailable + cost > pdb.max_unavailable:
                return (f"pdb {pdb.meta.key}: unavailable {unavailable}+{cost}"
                        f" > maxUnavailable {pdb.max_unavailable}")
    return None


class EvictionAPIEvictor:
    """Default evictor: evictability + PDB guard, then terminate the pod the
    way the eviction subresource does. Subclasses override `respects_pdb`
    and `_terminate` only; the guard chain stays in one place."""

    name = "EvictionAPI"
    respects_pdb = True

    def __init__(self, store: ObjectStore):
        self.store = store

    def evict(self, pod: Pod, reason: str) -> None:
        ok, why = is_evictable(pod)
        if not ok:
            raise EvictionBlocked(why)
        if self.respects_pdb:
            violated = check_pdbs(self.store, pod)
            if violated:
                raise EvictionBlocked(violated)
        self._terminate(pod, reason)

    def _terminate(self, pod: Pod, reason: str) -> None:
        terminate_pod(self.store, pod, "koordinator.sh/evicted", reason)


class DeleteEvictor(EvictionAPIEvictor):
    """Direct-delete mode: skips PDBs (the operator asked for force)."""

    name = "Delete"
    respects_pdb = False

    def _terminate(self, pod: Pod, reason: str) -> None:
        self.store.delete(KIND_POD, pod.meta.key)


class SoftEvictor:
    """Annotate-only: marks the pod for the node agent to drain gracefully."""

    name = "SoftEviction"

    def __init__(self, store: ObjectStore):
        self.store = store

    def evict(self, pod: Pod, reason: str) -> None:
        ok, why = is_evictable(pod)
        if not ok:
            raise EvictionBlocked(why)
        pod.meta.annotations[ANNOTATION_SOFT_EVICTION] = reason
        self.store.update(KIND_POD, pod)


EVICTOR_BY_NAME = {
    EvictionAPIEvictor.name: EvictionAPIEvictor,
    DeleteEvictor.name: DeleteEvictor,
    SoftEvictor.name: SoftEvictor,
}
