"""Storage-aware worlds for the Scheduler: a seeded layer of StorageClasses,
PersistentVolumes and claims over a synthetic cluster.

The layer is the shape of a typical production cluster's storage:

  * three zones (``topology.kubernetes.io/zone``) over the nodes;
  * ``local-static``: WaitForFirstConsumer, no provisioner, with static
    zonal PVs (Available) that unbound claims bind to at schedule time;
  * ``csi-dynamic``: WaitForFirstConsumer with a CSI provisioner whose
    ``allowedTopologies`` name two of the zones; ``provision`` plays the
    external provisioner between cycles, creating a PV in the zone of the
    node the scheduler selected;
  * ``standard``: Immediate, each claim already bound to a zonal PV (the
    VolumeZone pairs).

A fraction of the pending pods carry one or two claims. ``storage_plan``
returns plain data, so one plan can be laid onto twin worlds of either
package (as ``testing/churn.arrival_specs`` are): ``layer_storage`` lays it
onto a ClusterState before ``store_from_state`` loads it, and
``claim_arrivals`` gives churn arrivals claims (half of them sharing a bound
claim, the hot claims of the fused waves). ``storage_dump`` is the
canonical dump of every claim's and volume's binding, compared between
twins.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from koordinator_tpu_torch.client.store import (
    KIND_NODE,
    KIND_PV,
    KIND_PVC,
    KIND_STORAGECLASS,
)

ZONE_LABEL = "topology.kubernetes.io/zone"
ZONES = ("z0", "z1", "z2")
STATIC_CLASS = "local-static"
DYNAMIC_CLASS = "csi-dynamic"
IMMEDIATE_CLASS = "standard"
NO_PROVISIONER = "kubernetes.io/no-provisioner"
CSI_PROVISIONER = "pd.csi.storage.gke.io"
IMMEDIATE_PROVISIONER = "ebs.csi.aws.com"
WAIT_FOR_FIRST_CONSUMER = "WaitForFirstConsumer"
SELECTED_NODE_ANNOTATION = "volume.kubernetes.io/selected-node"
# the class of a pending pod's claim: static, dynamic, immediate
CLASS_WEIGHTS = (0.5, 0.2, 0.3)
GIB = 1024 ** 3


def _modules(objects, resource_list):
    if objects is None:
        from koordinator_tpu_torch.api import objects
    if resource_list is None:
        from koordinator_tpu_torch.api.resources import ResourceList

        resource_list = ResourceList
    return objects, resource_list


def storage_plan(node_names: Sequence[str], pod_keys: Sequence[str],
                 seed: int, claim_fraction: float = 0.2,
                 static_pv_ratio: float = 1.1) -> Dict:
    """The storage layer as plain data: node zones, each claim-carrying
    pod's claim names, the claims and the volumes (static PVs, about
    ``static_pv_ratio`` per static claim, over the three zones)."""
    rng = np.random.default_rng(seed)
    zones = {name: ZONES[i % len(ZONES)] for i, name in enumerate(node_names)}
    classes = (STATIC_CLASS, DYNAMIC_CLASS, IMMEDIATE_CLASS)
    claims: Dict[str, List[str]] = {}
    pvcs: List[Dict] = []
    pvs: List[Dict] = []
    for key in pod_keys:
        if rng.random() >= claim_fraction:
            continue
        ns, name = key.split("/", 1)
        names = []
        for j in range(1 + int(rng.random() < 0.5)):
            cls = classes[int(rng.choice(3, p=CLASS_WEIGHTS))]
            gib = int(rng.integers(5, 100))
            cname = f"{name}-data-{j}"
            pvc = dict(namespace=ns, name=cname, cls=cls, gib=gib,
                       volume="")
            if cls == IMMEDIATE_CLASS:
                pv_name = f"pv-{ns}-{cname}"
                pvs.append(dict(name=pv_name,
                                zone=ZONES[int(rng.integers(len(ZONES)))],
                                gib=gib, cls=cls, claim=f"{ns}/{cname}"))
                pvc["volume"] = pv_name
            pvcs.append(pvc)
            names.append(cname)
        claims[key] = names
    n_static = sum(1 for c in pvcs if c["cls"] == STATIC_CLASS)
    for k in range(int(n_static * static_pv_ratio)):
        pvs.append(dict(name=f"pv-static-{k}", zone=ZONES[k % len(ZONES)],
                        gib=int(rng.integers(10, 200)), cls=STATIC_CLASS,
                        claim=""))
    return dict(zones=zones, claims=claims, pvcs=pvcs, pvs=pvs)


def storage_classes(objects=None) -> List:
    """The three StorageClasses of the layer."""
    objects, _rl = _modules(objects, None)
    meta = objects.ObjectMeta
    return [
        objects.StorageClass(meta=meta(name=STATIC_CLASS, namespace=""),
                             provisioner=NO_PROVISIONER,
                             volume_binding_mode=WAIT_FOR_FIRST_CONSUMER),
        objects.StorageClass(meta=meta(name=DYNAMIC_CLASS, namespace=""),
                             provisioner=CSI_PROVISIONER,
                             volume_binding_mode=WAIT_FOR_FIRST_CONSUMER,
                             allowed_topologies=[
                                 ((ZONE_LABEL, ZONES[:2]),)]),
        objects.StorageClass(meta=meta(name=IMMEDIATE_CLASS, namespace=""),
                             provisioner=IMMEDIATE_PROVISIONER),
    ]


def make_pvc(spec: Dict, objects=None, resource_list=None):
    objects, rl = _modules(objects, resource_list)
    return objects.PersistentVolumeClaim(
        meta=objects.ObjectMeta(name=spec["name"],
                                namespace=spec["namespace"]),
        capacity=rl({"storage": spec["gib"] * GIB}),
        storage_class_name=spec["cls"],
        volume_name=spec["volume"],
        phase="Bound" if spec["volume"] else "Pending")


def make_pv(spec: Dict, objects=None, resource_list=None):
    objects, rl = _modules(objects, resource_list)
    pv = objects.PersistentVolume(
        meta=objects.ObjectMeta(name=spec["name"], namespace=""),
        capacity=rl({"storage": spec["gib"] * GIB}),
        storage_class_name=spec["cls"],
        claim_ref=spec["claim"],
        phase="Bound" if spec["claim"] else "Available")
    pv.meta.labels[ZONE_LABEL] = spec["zone"]
    return pv


def layer_storage(state, plan: Dict, objects=None,
                  resource_list=None) -> None:
    """Lay ``plan`` onto a ClusterState of either package (pass the JAX
    package's ``objects`` module and ``ResourceList`` for its twin): zone
    labels on the nodes, claim names on the pending pods, and the classes,
    claims and volumes into ``state.storage_classes``/``pvcs``/``pvs``,
    which ``store_from_state`` loads."""
    for node in state.nodes:
        node.meta.labels[ZONE_LABEL] = plan["zones"][node.meta.name]
    for pod in state.pending_pods:
        names = plan["claims"].get(pod.meta.key)
        if names:
            pod.spec.pvc_names = list(names)
    for sc in storage_classes(objects):
        state.storage_classes[sc.meta.name] = sc
    for spec in plan["pvcs"]:
        pvc = make_pvc(spec, objects, resource_list)
        state.pvcs[pvc.meta.key] = pvc
    for spec in plan["pvs"]:
        pv = make_pv(spec, objects, resource_list)
        state.pvs[pv.meta.name] = pv


def claim_arrivals(specs: List[Dict], cycle: int, seed: int,
                   claim_fraction: float = 0.2) -> Tuple[List[Dict], Dict]:
    """Churn arrivals with claims: about ``claim_fraction`` of them carry
    one, half of those a bound Immediate claim shared with the next such
    arrival (a hot claim), the rest a fresh static claim with a static PV
    beside it. Returns (the specs with a ``claims`` key, the storage to
    add first: {"pvcs": [...], "pvs": [...]})."""
    rng = np.random.default_rng(seed * 1000 + cycle)
    out, pvcs, pvs = [], [], []
    shared: Optional[str] = None
    for b in specs:
        b = dict(b)
        if rng.random() < claim_fraction:
            if rng.random() < 0.5:
                if shared is None:
                    shared = f"shared-{cycle}-{len(pvcs)}"
                    pv_name = f"pv-churn-{shared}"
                    pvcs.append(dict(namespace="churn", name=shared,
                                     cls=IMMEDIATE_CLASS, gib=20,
                                     volume=pv_name))
                    pvs.append(dict(
                        name=pv_name,
                        zone=ZONES[int(rng.integers(len(ZONES)))],
                        gib=20, cls=IMMEDIATE_CLASS,
                        claim=f"churn/{shared}"))
                    b["claims"] = [shared]
                else:
                    b["claims"] = [shared]
                    shared = None
            else:
                cname = f"{b['name']}-data"
                gib = int(rng.integers(5, 100))
                pvcs.append(dict(namespace="churn", name=cname,
                                 cls=STATIC_CLASS, gib=gib, volume=""))
                pvs.append(dict(name=f"pv-static-{cname}",
                                zone=ZONES[int(rng.integers(len(ZONES)))],
                                gib=gib + int(rng.integers(0, 50)),
                                cls=STATIC_CLASS, claim=""))
                b["claims"] = [cname]
        out.append(b)
    return out, {"pvcs": pvcs, "pvs": pvs}


def add_storage(store, storage: Dict, objects=None,
                resource_list=None) -> None:
    """Add ``claim_arrivals``' claims and volumes to ``store``."""
    for spec in storage["pvs"]:
        store.add(KIND_PV, make_pv(spec, objects, resource_list))
    for spec in storage["pvcs"]:
        store.add(KIND_PVC, make_pvc(spec, objects, resource_list))


def provision(store, objects=None, resource_list=None) -> int:
    """The external dynamic provisioner: for every unbound ``csi-dynamic``
    claim the scheduler annotated with a selected node, create a PV of the
    claim's size in that node's zone (once). Returns how many it created;
    deterministic (claims in key order)."""
    made = 0
    for pvc in sorted(store.list(KIND_PVC), key=lambda c: c.meta.key):
        node_name = pvc.meta.annotations.get(SELECTED_NODE_ANNOTATION)
        if (pvc.storage_class_name != DYNAMIC_CLASS or pvc.is_bound
                or not node_name):
            continue
        name = f"pv-dyn-{pvc.meta.namespace}-{pvc.meta.name}"
        if store.get(KIND_PV, f"/{name}") is not None:
            continue
        node = store.get(KIND_NODE, f"/{node_name}")
        gib = int(pvc.capacity.get("storage") // GIB)
        store.add(KIND_PV, make_pv(
            dict(name=name, zone=node.meta.labels[ZONE_LABEL], gib=gib,
                 cls=DYNAMIC_CLASS, claim=""), objects, resource_list))
        made += 1
    return made


def storage_dump(store) -> Dict:
    """Every claim's (volume, phase, selected node) and every volume's
    (claim, phase): the PV picks two twins must agree on."""
    pvcs = {c.meta.key: (c.volume_name, c.phase,
                         c.meta.annotations.get(SELECTED_NODE_ANNOTATION))
            for c in store.list(KIND_PVC)}
    pvs = {v.meta.name: (v.claim_ref, v.phase)
           for v in store.list(KIND_PV)}
    return {"pvcs": pvcs, "pvs": pvs}


def storage_churn_store(num_nodes: int, num_pods: int, seed: int = 42,
                        claim_fraction: float = 0.2):
    """(store, state): ``testing/churn.churn_store``'s world with the
    storage layer of ``storage_plan`` (its seed) laid on before the store
    is loaded; an independent synth per call, as churn_store's."""
    from koordinator_tpu_torch.testing.churn import store_from_state
    from koordinator_tpu_torch.testing.synth import synth_full_cluster

    _cluster, state = synth_full_cluster(
        num_nodes, num_pods, seed=seed,
        num_quotas=max(8, num_pods // 100),
        num_gangs=max(4, num_pods // 50))
    plan = storage_plan([n.meta.name for n in state.nodes],
                        [p.meta.key for p in state.pending_pods], seed=seed,
                        claim_fraction=claim_fraction)
    layer_storage(state, plan)
    return store_from_state(state), state


def bound_claims_world(store, objects=None, resource_list=None):
    """Fill an empty ``store`` of either package with the fused waves'
    claims world (pipeline_parity's claims world: hot claims shared
    between pending pods and attached on nodes, attachment limits of 3,
    a pod feasible only after another's in-dispatch attachment) with
    every claim a PVC bound to a zoneless PV of an Immediate class: the
    classification is real, nothing is unbound, and the fused dispatch
    carries the hot claims. Returns the store."""
    from koordinator_tpu_torch.client.store import KIND_NODE, KIND_POD

    objects, rl = _modules(objects, resource_list)
    meta = objects.ObjectMeta
    for i in range(4):
        node = objects.Node(
            meta=meta(name=f"n{i}", namespace="", labels={"vg": str(i)}),
            allocatable=rl.of(cpu=32000, memory=64 * GIB, pods=80))
        node.attachable_volume_limit = 3
        store.add(KIND_NODE, node)
    store.add(KIND_STORAGECLASS, objects.StorageClass(
        meta=meta(name=IMMEDIATE_CLASS, namespace=""),
        provisioner=IMMEDIATE_PROVISIONER))
    for c in ("shared-x", "a0", "new-1", "shared-y", "y-extra", "y-extra2",
              "u1", "u2"):
        pv = objects.PersistentVolume(
            meta=meta(name=f"pv-{c}", namespace=""),
            capacity=rl({"storage": 100 * GIB}),
            storage_class_name=IMMEDIATE_CLASS, claim_ref=f"default/{c}",
            phase="Bound")
        store.add(KIND_PV, pv)
        store.add(KIND_PVC, make_pvc(dict(
            namespace="default", name=c, cls=IMMEDIATE_CLASS, gib=10,
            volume=pv.meta.name), objects, rl))

    def pod(name, cpu, claims, node_name="", selector=None):
        p = objects.Pod(
            meta=meta(name=name, uid=name, creation_timestamp=1.0),
            spec=objects.PodSpec(
                requests=rl.of(cpu=cpu, memory=GIB, pods=1),
                pvc_names=list(claims)))
        if node_name:
            p.spec.node_name = node_name
            p.phase = "Running"
        if selector:
            p.spec.node_selector = dict(selector)
        store.add(KIND_POD, p)

    pod("b0", 1000, ["shared-x", "a0"], node_name="n0")
    pod("b1", 1000, ["shared-x"], node_name="n1")
    pod("q1", 500, ["shared-x", "new-1"])
    pod("q2", 500, ["shared-y", "y-extra", "y-extra2"], selector={"vg": "2"})
    pod("q3", 500, ["shared-y"], selector={"vg": "2"})
    pod("q4", 500, ["u1", "u2"])
    pod("plain", 700, [])
    return store
