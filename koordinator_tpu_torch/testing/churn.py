"""Stores for driving the Scheduler cycle: bench.py's churn shape.

``churn_store`` is bench.py's ``run_churn`` world (BASELINE config 4 through
the real cycle): ``synth_full_cluster`` loaded into an ObjectStore, with
``run_churn``'s quota and gang counts. ``arrival_specs`` are its per-cycle
arrivals as plain dicts, so that one list can be applied to several stores
(``add_arrivals``), of either package. ``cycle_dump`` is the canonical dump
two schedulers' worlds are compared by.
"""

from __future__ import annotations

from typing import Dict, List

from koordinator_tpu_torch.api.objects import ObjectMeta, Pod, PodSpec
from koordinator_tpu_torch.api.resources import ResourceList
from koordinator_tpu_torch.client.store import (
    KIND_ELASTIC_QUOTA,
    KIND_NODE,
    KIND_NODE_METRIC,
    KIND_NODE_TOPOLOGY,
    KIND_POD,
    KIND_POD_GROUP,
    KIND_PV,
    KIND_PVC,
    KIND_STORAGECLASS,
    ObjectStore,
)
from koordinator_tpu_torch.testing.synth import synth_full_cluster

GIB = 1024 ** 3


def store_from_state(state, store=None):
    """Load a synthetic ClusterState into a store (a new ObjectStore unless
    one is given — pass the JAX package's to build its twin)."""
    store = ObjectStore() if store is None else store
    for n in state.nodes:
        store.add(KIND_NODE, n)
    for nm in state.node_metrics.values():
        store.add(KIND_NODE_METRIC, nm)
    for p in state.pods_by_key.values():
        store.add(KIND_POD, p)
    for p in state.pending_pods:
        store.add(KIND_POD, p)
    for pg in state.pod_groups:
        store.add(KIND_POD_GROUP, pg)
    for q in state.quotas:
        store.add(KIND_ELASTIC_QUOTA, q)
    for t in state.topologies.values():
        store.add(KIND_NODE_TOPOLOGY, t)
    for sc in state.storage_classes.values():
        store.add(KIND_STORAGECLASS, sc)
    for pv in state.pvs.values():
        store.add(KIND_PV, pv)
    for pvc in state.pvcs.values():
        store.add(KIND_PVC, pvc)
    return store


def churn_store(num_nodes: int, num_pods: int, seed: int = 42):
    """(store, state): an INDEPENDENT synth per call, so twin schedulers
    never share object instances (a binding in one world would mutate the
    other's pods). Quota and gang counts are run_churn's."""
    _cluster, state = synth_full_cluster(
        num_nodes, num_pods, seed=seed,
        num_quotas=max(8, num_pods // 100),
        num_gangs=max(4, num_pods // 50))
    return store_from_state(state), state


def arrival_specs(cycle: int, arrivals: int) -> List[Dict]:
    """run_churn's arrivals of churn cycle ``cycle`` (1-based)."""
    return [dict(name=f"churn-{cycle}-{i}", uid=f"churn-{cycle}-{i}",
                 prio=5000 + (i % 4) * 1000,
                 cpu=250 * (1 + i % 8), mem=(1 + i % 4) * GIB)
            for i in range(arrivals)]


def add_arrivals(store, specs: List[Dict], created: float,
                 objects=None, resource_list=None) -> None:
    """Add the arrival pods to ``store``, created at ``created``, with the
    claims a spec names (``claims``, testing/storage.claim_arrivals). The
    JAX package's twin passes its own ``objects`` module and
    ``ResourceList``."""
    meta_cls = objects.ObjectMeta if objects is not None else ObjectMeta
    pod_cls = objects.Pod if objects is not None else Pod
    spec_cls = objects.PodSpec if objects is not None else PodSpec
    rl = resource_list if resource_list is not None else ResourceList
    for b in specs:
        pod = pod_cls(
            meta=meta_cls(name=b["name"], namespace="churn", uid=b["uid"],
                          creation_timestamp=created),
            spec=spec_cls(priority=b["prio"],
                          requests=rl.of(cpu=b["cpu"], memory=b["mem"],
                                         pods=1)),
        )
        if b.get("claims"):
            pod.spec.pvc_names = list(b["claims"])
        store.add(KIND_POD, pod)


def cycle_dump(sched) -> Dict:
    """Canonical dump of a scheduler's world: for every pod its node, its
    annotations and its PodScheduled condition (status, reason, message);
    every PodGroup's status; every ElasticQuota's used vector. Reads only
    attribute names the two packages share, so it dumps either."""
    store = sched.store
    pods = {}
    for p in store.list(KIND_POD):
        cond = p.get_condition("PodScheduled")
        pods[p.meta.key] = (
            p.spec.node_name, sorted(p.meta.annotations.items()),
            None if cond is None else (cond.status, cond.reason,
                                       cond.message))
    groups = {pg.meta.key: (pg.phase, pg.scheduled)
              for pg in store.list(KIND_POD_GROUP)}
    quota = sched.extender.plugin("ElasticQuota")
    used = {}
    for q in store.list(KIND_ELASTIC_QUOTA):
        vec = quota.used.get(q.meta.name) if quota is not None else None
        used[q.meta.name] = None if vec is None else [float(x) for x in vec]
    return {"pods": pods, "pod_groups": groups, "quota_used": used}
