"""Store-level cluster invariants: what must hold after EVERY cycle.

The single source both the churn soak test (tests/test_churn_soak.py)
and the simulator's per-cycle net assert. Mirrors what the reference's
admission chain guarantees: no node overcommitted past its (trimmed)
allocatable, no hostPort double-bind, CSI volume limits respected, gang
all-or-nothing. Returns breach DESCRIPTIONS instead of asserting so the
simulator can count, flight-dump, and keep churning — the test layer
asserts the list is empty.
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np

from koordinator_tpu_torch.client.store import (
    KIND_NODE,
    KIND_POD,
    KIND_POD_GROUP,
    KIND_POD_MIGRATION_JOB,
    KIND_RESERVATION,
    ObjectStore,
)
from koordinator_tpu_torch.ops.estimator import estimate_node_allocatable


def check_invariants(store: ObjectStore,
                     now: Optional[float] = None,
                     batch_shrink_grace: bool = False) -> List[str]:
    """Check the invariant set against the store; [] == clean.
    ``now`` governs reservation expiry (sim clock); defaults to wall.

    ``batch_shrink_grace`` (koordcolo scenarios): the batch/mid axes are
    OVERCOMMIT — the colo loop may legitimately shrink a node's batch
    allocatable below what already-bound batch pods consume (the
    reference reclaims via BE eviction, asynchronously). With the grace
    on, the capacity check skips those axes and the bind-time discipline
    is pinned separately by :func:`check_batch_bind_discipline` (new
    binds must respect the CURRENT overcommit; existing binds may ride
    out a shrink)."""
    now = time.time() if now is None else now
    breaches: List[str] = []
    grace_axes: List[int] = []
    if batch_shrink_grace:
        from koordinator_tpu_torch.api.resources import (
            RESOURCE_INDEX,
            ResourceName,
        )

        grace_axes = [RESOURCE_INDEX[rn] for rn in (
            ResourceName.BATCH_CPU, ResourceName.BATCH_MEMORY,
            ResourceName.MID_CPU, ResourceName.MID_MEMORY)]
    nodes = {n.meta.name: n for n in store.list(KIND_NODE)}
    pods = [p for p in store.list(KIND_POD)
            if p.is_assigned and not p.is_terminated]
    by_node = {}
    for p in pods:
        by_node.setdefault(p.spec.node_name, []).append(p)
    for name, plist in by_node.items():
        node = nodes.get(name)
        if node is None:
            breaches.append(f"pod bound to unknown node {name}")
            continue
        # 1. capacity: sum of requests <= trimmed allocatable per axis
        alloc = estimate_node_allocatable(node)
        total = np.zeros_like(alloc)
        for p in plist:
            total = total + p.spec.requests.to_vector()
        over = total > alloc + 1e-3
        if grace_axes:
            over[grace_axes] = False
        if over.any():
            breaches.append(
                f"node {name} overcommitted: {total[over]} > {alloc[over]}")
        # 1b. pod-count axis: requests vectors carry no pods term (the
        # kernel adds the +1-per-pod via with_pod_count), so the axis
        # check above cannot see pod-count overcommit — count directly.
        # Matters across a crash-restart boundary, where the fresh
        # scheduler re-derives every per-node sum from the store.
        from koordinator_tpu_torch.api.resources import RESOURCE_INDEX, ResourceName

        pods_cap = float(alloc[RESOURCE_INDEX[ResourceName.PODS]])
        if pods_cap > 0 and len(plist) > pods_cap:
            breaches.append(
                f"node {name} exceeds its pod capacity: "
                f"{len(plist)} > {pods_cap:g}")
        # 2. hostPorts: no (protocol, port) bound twice
        seen = set()
        for p in plist:
            for slot in p.spec.host_ports:
                if slot in seen:
                    breaches.append(
                        f"hostPort {slot} double-bound on {name}")
                seen.add(slot)
        # 3. volume limit
        if node.attachable_volume_limit > 0:
            claims = set()
            for p in plist:
                claims.update(
                    f"{p.meta.namespace}/{c}" for c in p.spec.pvc_names)
            if len(claims) > node.attachable_volume_limit:
                breaches.append(
                    f"node {name} exceeds volume limit: "
                    f"{len(claims)} > {node.attachable_volume_limit}")
    # 4. gang all-or-nothing: a gang with any bound member has >= min bound
    gangs = {g.meta.key: g for g in store.list(KIND_POD_GROUP)}
    bound_per_gang = {}
    for p in pods:
        g = p.gang_key
        if g:
            bound_per_gang[g] = bound_per_gang.get(g, 0) + 1
    for g, count in bound_per_gang.items():
        pg = gangs.get(g)
        if pg is not None and count < pg.min_member:
            breaches.append(
                f"gang {g} partially bound: {count} < {pg.min_member}")
    # 5. rebalance discipline: an active migration job must target a
    # MOVABLE pod — never a DaemonSet replica or a pod carrying the
    # PDB-like opt-out guard (a missing/terminated pod is a lifecycle
    # race the controller resolves, not a breach)
    from koordinator_tpu_torch.balance.pack import has_pdb_like_guard

    for job in store.list(KIND_POD_MIGRATION_JOB):
        if job.phase not in ("Pending", "Running"):
            continue
        pod = store.get(KIND_POD, f"{job.pod_namespace}/{job.pod_name}")
        if pod is None or pod.is_terminated:
            continue
        if has_pdb_like_guard(pod):
            breaches.append(
                f"migration job {job.meta.key} targets PDB-guarded pod "
                f"{pod.meta.key}")
        if pod.meta.owner_kind == "DaemonSet":
            breaches.append(
                f"migration job {job.meta.key} targets DaemonSet pod "
                f"{pod.meta.key}")
    # 6. reserved capacity is not double-booked: per node, assigned pod
    # requests PLUS the unconsumed remainder of Available unexpired
    # reservations must fit the trimmed allocatable (the scheduler
    # counts held reservation capacity via ReservationRestoreTransformer
    # — this pins that the rebalance closed loop cannot overcommit a
    # node through its replacement reservations)
    reserved = {}
    for res in store.list(KIND_RESERVATION):
        if not res.is_available or res.is_expired(now):
            continue
        free = np.maximum(
            res.allocatable.to_vector() - res.allocated.to_vector(), 0.0)
        reserved[res.node_name] = reserved.get(res.node_name, 0.0) + free
    for name, held in reserved.items():
        node = nodes.get(name)
        if node is None:
            breaches.append(f"reservation held on unknown node {name}")
            continue
        alloc = estimate_node_allocatable(node)
        total = np.asarray(held, np.float64).copy()
        for p in by_node.get(name, []):
            total = total + p.spec.requests.to_vector()
        over = total > alloc + 1e-3
        if over.any():
            breaches.append(
                f"node {name} double-booked by reservations: "
                f"{total[over]} > {alloc[over]}")
    return breaches


def check_batch_bind_discipline(store: ObjectStore,
                                bound_keys) -> List[str]:
    """koordcolo bind-time invariant: a batch-class pod bound THIS cycle
    must fit the node's CURRENT batch/mid allocatable together with
    every batch pod already there — the dispatch that placed it consumed
    the overcommit the colo pass published this very cycle, so a bind
    into an already-over node means the scheduler read stale overcommit
    (the closed loop failed). Existing binds riding out a later shrink
    are legitimate (see check_invariants batch_shrink_grace)."""
    from koordinator_tpu_torch.api.resources import RESOURCE_INDEX, ResourceName

    axes = [RESOURCE_INDEX[rn] for rn in (
        ResourceName.BATCH_CPU, ResourceName.BATCH_MEMORY,
        ResourceName.MID_CPU, ResourceName.MID_MEMORY)]
    breaches: List[str] = []
    touched = set()
    for key in bound_keys:
        pod = store.get(KIND_POD, key)
        if pod is None or not pod.is_assigned or pod.is_terminated:
            continue
        vec = pod.spec.requests.to_vector()
        if not any(vec[a] > 0 for a in axes):
            continue
        touched.add(pod.spec.node_name)
    if not touched:
        return breaches
    # ONE store walk accumulating per-node totals (the check above
    # already walks pods once; k touched nodes must not mean k walks)
    totals: dict = {}
    for p in store.list(KIND_POD):
        if (p.is_assigned and not p.is_terminated
                and p.spec.node_name in touched):
            node_total = totals.get(p.spec.node_name)
            vec = p.spec.requests.to_vector()
            totals[p.spec.node_name] = (
                vec if node_total is None else node_total + vec)
    for name in touched:
        node = store.get(KIND_NODE, f"/{name}")
        if node is None:
            continue
        alloc = estimate_node_allocatable(node)
        total = totals.get(name)
        if total is None:
            continue
        for a in axes:
            if total[a] > alloc[a] + 1e-3:
                breaches.append(
                    f"batch bind onto {name} exceeds current overcommit "
                    f"axis {a}: {total[a]} > {alloc[a]}")
    return breaches
