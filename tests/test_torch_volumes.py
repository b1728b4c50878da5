"""Storage-aware clusters on the port: PVC, PV and StorageClass objects
through the snapshot pack and the Scheduler, against the JAX package.

Every world is built twice by one function, once with each package's
objects. The worlds:

  * the VolumeBinding worlds of tests/test_volumebinding.py (WaitForFirst-
    Consumer zone pinning, unbound Immediate claims, missing claims and
    classes, claims satisfiable nowhere, dynamic provisioning over two
    cycles with the provisioner in between, allowedTopologies, the smallest
    matching PV, two pods racing for one PV, zoneless and claimRef
    pre-bound PVs, a ghost claim) and the VolumeZone world of
    tests/test_ports_volumes_image.py;
  * the claims world of the fused waves (tests/test_fused_waves.py,
    pipeline_parity._claims_world) with every claim a real bound PVC: hot
    claims ride the fused dispatch from real objects; and more hot claims
    than the dispatch's claim columns, which demotes it
    (``claim-entangled``, the factorization-budget overflow);
  * a seeded storage layer (testing/storage.py) over a synthetic cluster
    with churn arrivals carrying claims, and the external provisioner
    between cycles: its unbound claims on several pending pods demote the
    fused dispatch (``claim-entangled``) in both packages.

Each runs through the JAX Scheduler and the port's, serial and with
``waves=4``, and every cycle must agree on the ordered bindings, the failed
and rejected lists, the failure reasons, the demotions, every claim's and
volume's binding and annotations (the PV picks), and the canonical dump
(PodScheduled messages included). The packed FullChainInputs are
array-equal cold (build_full_chain_inputs on twin states, bit columns of
the admission mask included, past the mask's bit budget too) and cached
(the Scheduler's encode, through the SnapshotCache). The JAX runs are
cached per world.
"""

from __future__ import annotations

import functools
from types import SimpleNamespace

import numpy as np
import pytest

from koordinator_tpu.api import objects as ref_objects
from koordinator_tpu.api.resources import ResourceList as RefResourceList
from koordinator_tpu.client import store as ref_store_mod
from koordinator_tpu.scheduler.cycle import Scheduler as RefScheduler
from koordinator_tpu.testing import synth_full_cluster as ref_synth

from koordinator_tpu_torch.api import objects as port_objects
from koordinator_tpu_torch.api.resources import ResourceList
from koordinator_tpu_torch.client import store as port_store_mod
from koordinator_tpu_torch.scheduler.cycle import Scheduler
from koordinator_tpu_torch.testing import synth_full_cluster
from koordinator_tpu_torch.testing.churn import (
    add_arrivals,
    arrival_specs,
    cycle_dump,
    store_from_state,
)
from koordinator_tpu_torch.testing.storage import (
    SELECTED_NODE_ANNOTATION,
    ZONE_LABEL,
    add_storage,
    bound_claims_world,
    claim_arrivals,
    layer_storage,
    provision,
    storage_dump,
    storage_plan,
)

from test_torch_pack import _assert_packs_equal, _fields

GIB = 1024 ** 3
NOW = 1_000_000.0
WFFC = "WaitForFirstConsumer"

REF = SimpleNamespace(objects=ref_objects, rl=RefResourceList,
                      store=ref_store_mod)
PORT = SimpleNamespace(objects=port_objects, rl=ResourceList,
                       store=port_store_mod)


# ---------------------------------------------------------------------------
# the worlds, each made for one package (``pkg`` is REF or PORT)
# ---------------------------------------------------------------------------

def _nodes(pkg, num_nodes=4, zones=2, **alloc):
    store = pkg.store.ObjectStore()
    for i in range(num_nodes):
        node = pkg.objects.Node(
            meta=pkg.objects.ObjectMeta(name=f"n{i}", namespace=""),
            allocatable=pkg.rl.of(**({"cpu": 8000, "memory": 32 * GIB,
                                      "pods": 20} | alloc)))
        node.meta.labels[ZONE_LABEL] = f"z{i % zones}"
        store.add(pkg.store.KIND_NODE, node)
    return store


def _sc(pkg, name="local", provisioner="kubernetes.io/no-provisioner",
        mode=WFFC, allowed=()):
    return pkg.objects.StorageClass(
        meta=pkg.objects.ObjectMeta(name=name, namespace=""),
        provisioner=provisioner, volume_binding_mode=mode,
        allowed_topologies=list(allowed))


def _pv(pkg, name, zone=None, gib=100, sc="local", claim_ref=""):
    pv = pkg.objects.PersistentVolume(
        meta=pkg.objects.ObjectMeta(name=name, namespace=""),
        capacity=pkg.rl({"storage": gib * GIB}), storage_class_name=sc,
        claim_ref=claim_ref, phase="Bound" if claim_ref else "Available")
    if zone is not None:
        pv.meta.labels[ZONE_LABEL] = zone
    return pv


def _pvc(pkg, name, sc="local", gib=10, volume=""):
    return pkg.objects.PersistentVolumeClaim(
        meta=pkg.objects.ObjectMeta(name=name, namespace="default"),
        capacity=pkg.rl({"storage": gib * GIB}), storage_class_name=sc,
        volume_name=volume, phase="Bound" if volume else "")


def _pod(pkg, name, claims, cpu=1000, **spec):
    pod = pkg.objects.Pod(
        meta=pkg.objects.ObjectMeta(name=name, uid=name,
                                    creation_timestamp=1.0),
        spec=pkg.objects.PodSpec(
            requests=pkg.rl.of(cpu=cpu, memory=GIB, pods=1), **spec))
    pod.spec.pvc_names = list(claims)
    return pod


def _add(store, pkg, kind, *objs):
    for obj in objs:
        store.add(getattr(pkg.store, kind), obj)


def w_wffc_zone(pkg):
    store = _nodes(pkg)
    _add(store, pkg, "KIND_STORAGECLASS", _sc(pkg))
    _add(store, pkg, "KIND_PV", _pv(pkg, "pv-1", zone="z1"))
    _add(store, pkg, "KIND_PVC", _pvc(pkg, "data"))
    _add(store, pkg, "KIND_POD", _pod(pkg, "db", ["data"]))
    return store


def w_unbound_immediate(pkg):
    store = _nodes(pkg, 2)
    _add(store, pkg, "KIND_STORAGECLASS",
         _sc(pkg, "std", "ebs.csi.aws.com", mode="Immediate"))
    _add(store, pkg, "KIND_PVC", _pvc(pkg, "data", sc="std"))
    _add(store, pkg, "KIND_POD", _pod(pkg, "db", ["data"]))
    return store


def w_classless(pkg):
    store = _nodes(pkg, 2)
    _add(store, pkg, "KIND_PVC", _pvc(pkg, "data", sc=""))
    _add(store, pkg, "KIND_POD", _pod(pkg, "db", ["data"]))
    return store


def w_missing(pkg):
    store = _nodes(pkg, 2)
    _add(store, pkg, "KIND_POD", _pod(pkg, "a", ["ghost"]))
    _add(store, pkg, "KIND_PVC", _pvc(pkg, "data", sc="no-such-class"))
    _add(store, pkg, "KIND_POD", _pod(pkg, "b", ["data"]))
    return store


def w_nowhere(pkg):
    store = _nodes(pkg, 3)
    _add(store, pkg, "KIND_STORAGECLASS", _sc(pkg))
    _add(store, pkg, "KIND_PVC", _pvc(pkg, "data"))
    _add(store, pkg, "KIND_POD", _pod(pkg, "db", ["data"]))
    return store


def w_dynamic(pkg):
    store = _nodes(pkg)
    _add(store, pkg, "KIND_STORAGECLASS",
         _sc(pkg, "csi", "pd.csi.storage.gke.io"))
    _add(store, pkg, "KIND_PVC", _pvc(pkg, "data", sc="csi"))
    _add(store, pkg, "KIND_POD", _pod(pkg, "db", ["data"]))
    return store


def between_dynamic(store, pkg, cycle):
    """The provisioner: a PV in the selected node's zone."""
    pvc = store.get(pkg.store.KIND_PVC, "default/data")
    node_name = pvc.meta.annotations.get(SELECTED_NODE_ANNOTATION)
    zone = store.get(pkg.store.KIND_NODE, f"/{node_name}").meta.labels[
        ZONE_LABEL]
    _add(store, pkg, "KIND_PV", _pv(pkg, "pv-dyn", zone=zone, sc="csi"))


def w_allowed_topologies(pkg):
    store = _nodes(pkg)
    _add(store, pkg, "KIND_STORAGECLASS",
         _sc(pkg, "csi", "pd.csi.storage.gke.io",
             allowed=[((ZONE_LABEL, ("z0",)),)]))
    _add(store, pkg, "KIND_PVC", _pvc(pkg, "data", sc="csi"))
    _add(store, pkg, "KIND_POD", _pod(pkg, "db", ["data"]))
    return store


def w_smallest_pv(pkg):
    store = _nodes(pkg, 2, zones=1)
    _add(store, pkg, "KIND_STORAGECLASS", _sc(pkg))
    _add(store, pkg, "KIND_PV", _pv(pkg, "pv-big", zone="z0", gib=500),
         _pv(pkg, "pv-small", zone="z0", gib=20),
         _pv(pkg, "pv-too-small", zone="z0", gib=5))
    _add(store, pkg, "KIND_PVC", _pvc(pkg, "data", gib=10))
    _add(store, pkg, "KIND_POD", _pod(pkg, "db", ["data"]))
    return store


def w_two_pods_race(pkg):
    store = _nodes(pkg, 3, zones=1)
    _add(store, pkg, "KIND_STORAGECLASS", _sc(pkg))
    _add(store, pkg, "KIND_PV", _pv(pkg, "pv-1", zone="z0"))
    _add(store, pkg, "KIND_PVC", _pvc(pkg, "c1"), _pvc(pkg, "c2"))
    _add(store, pkg, "KIND_POD", _pod(pkg, "p1", ["c1"]),
         _pod(pkg, "p2", ["c2"]))
    return store


def between_two_pods_race(store, pkg, cycle):
    _add(store, pkg, "KIND_PV", _pv(pkg, "pv-2", zone="z0"))


def w_zoneless(pkg):
    store = _nodes(pkg, 4, zones=4)
    _add(store, pkg, "KIND_STORAGECLASS", _sc(pkg))
    _add(store, pkg, "KIND_PV", _pv(pkg, "pv-any"))
    _add(store, pkg, "KIND_PVC", _pvc(pkg, "data"))
    _add(store, pkg, "KIND_POD", _pod(pkg, "db", ["data"]))
    return store


def w_prebound(pkg):
    store = _nodes(pkg, 2, zones=1)
    _add(store, pkg, "KIND_STORAGECLASS", _sc(pkg))
    _add(store, pkg, "KIND_PV",
         _pv(pkg, "pv-owned", zone="z0", claim_ref="default/other"))
    _add(store, pkg, "KIND_PVC", _pvc(pkg, "data"))
    _add(store, pkg, "KIND_POD", _pod(pkg, "db", ["data"]))
    return store


def w_ghost(pkg):
    store = _nodes(pkg, 2)
    _add(store, pkg, "KIND_STORAGECLASS", _sc(pkg))
    _add(store, pkg, "KIND_POD", _pod(pkg, "orphan", ["ghost"]))
    return store


def w_volume_zone(pkg):
    store = _nodes(pkg)
    _add(store, pkg, "KIND_PV", _pv(pkg, "pv-z0", zone="z0", sc=""))
    _add(store, pkg, "KIND_PVC", _pvc(pkg, "data", sc="", volume="pv-z0"))
    _add(store, pkg, "KIND_POD", _pod(pkg, "db", ["data"]))
    return store


def w_bound_claims(pkg):
    return bound_claims_world(pkg.store.ObjectStore(), objects=pkg.objects,
                              resource_list=pkg.rl)


def w_hot_claim_overflow(pkg):
    """More hot claims than the fused dispatch's claim columns: 130 bound
    claims, each shared by two pending pods. The factorization overflows
    its budget and the cycle demotes (claim-entangled), in both
    packages."""
    store = _nodes(pkg, 8, zones=2, pods=110)
    _add(store, pkg, "KIND_STORAGECLASS",
         _sc(pkg, "std", "ebs.csi.aws.com", mode="Immediate"))
    for i in range(130):
        c = f"hot-{i}"
        _add(store, pkg, "KIND_PV",
             _pv(pkg, f"pv-{c}", sc="std", claim_ref=f"default/{c}"))
        _add(store, pkg, "KIND_PVC",
             _pvc(pkg, c, sc="std", volume=f"pv-{c}"))
        _add(store, pkg, "KIND_POD", _pod(pkg, f"a-{i}", [c], cpu=50),
             _pod(pkg, f"b-{i}", [c], cpu=50))
    return store


LAYER_SEED, LAYER_NODES, LAYER_PODS = 5, 24, 160


def _layer_state(pkg, synth):
    """A synthetic cluster with the seeded storage layer."""
    _c, state = synth(LAYER_NODES, LAYER_PODS, seed=LAYER_SEED,
                      num_quotas=4, num_gangs=4)
    plan = storage_plan([n.meta.name for n in state.nodes],
                        [p.meta.key for p in state.pending_pods],
                        seed=LAYER_SEED, claim_fraction=0.3)
    layer_storage(state, plan, objects=pkg.objects, resource_list=pkg.rl)
    return state


def w_storage_layer(pkg):
    state = _layer_state(pkg, ref_synth if pkg is REF else
                         synth_full_cluster)
    return store_from_state(state, pkg.store.ObjectStore())


def between_storage_layer(store, pkg, cycle):
    """The provisioner, then churn arrivals carrying claims."""
    provision(store, objects=pkg.objects, resource_list=pkg.rl)
    specs, storage = claim_arrivals(arrival_specs(cycle, 40), cycle,
                                    seed=LAYER_SEED, claim_fraction=0.4)
    add_storage(store, storage, objects=pkg.objects, resource_list=pkg.rl)
    add_arrivals(store, specs, NOW + cycle, objects=pkg.objects,
                 resource_list=pkg.rl)


# name -> (make, cycles, between-cycle step or None)
WORLDS = {
    "wffc-zone": (w_wffc_zone, 1, None),
    "unbound-immediate": (w_unbound_immediate, 1, None),
    "classless": (w_classless, 1, None),
    "missing-claim-and-class": (w_missing, 1, None),
    "satisfiable-nowhere": (w_nowhere, 1, None),
    "dynamic-provisioning": (w_dynamic, 2, between_dynamic),
    "allowed-topologies": (w_allowed_topologies, 1, None),
    "smallest-pv": (w_smallest_pv, 1, None),
    "two-pods-race": (w_two_pods_race, 2, between_two_pods_race),
    "zoneless-pv": (w_zoneless, 1, None),
    "prebound-claim-ref": (w_prebound, 1, None),
    "ghost-claim": (w_ghost, 1, None),
    "volume-zone": (w_volume_zone, 1, None),
    "bound-claims": (w_bound_claims, 2, None),
    "hot-claim-overflow": (w_hot_claim_overflow, 1, None),
    "storage-layer": (w_storage_layer, 3, between_storage_layer),
}


def _key(res):
    return ([(b.pod_key, b.node_name) for b in res.bound],
            list(res.failed), list(res.rejected))


def _drive(sched, store, pkg, world):
    _make, cycles, between = WORLDS[world]
    fcs = []
    # copies: a later pass of the cycle may reuse the host arrays
    sched.encode_observer = lambda fc: fcs.append(
        {k: np.array(v, copy=True) for k, v in _fields(fc).items()})
    out = []
    for c in range(cycles):
        if c and between is not None:
            between(store, pkg, c)
        res = sched.run_cycle(now=NOW + 10 * c)
        out.append(dict(
            key=_key(res), waves=res.waves, demotions=list(res.demotions),
            reasons=list(sched.extender.error_handlers.failures),
            storage=storage_dump(store), dump=cycle_dump(sched)))
    return out, fcs


@functools.lru_cache(maxsize=None)
def _reference(world: str, waves: int):
    store = WORLDS[world][0](REF)
    sched = RefScheduler(store, waves=waves, explain="off", mesh="off",
                         warmup="off")
    return _drive(sched, store, REF, world)


@pytest.mark.parametrize("waves", [1, 4], ids=["serial", "waves4"])
@pytest.mark.parametrize("world", list(WORLDS))
def test_world_matches_reference(world, waves):
    store = WORLDS[world][0](PORT)
    sched = Scheduler(store, waves=waves, device="cpu")
    out, fcs = _drive(sched, store, PORT, world)
    ref_out, ref_fcs = _reference(world, waves)
    for c, (got, want) in enumerate(zip(out, ref_out)):
        for field in want:
            assert got[field] == want[field], (c, field)
    # the cached encode, field by field, every dispatch
    assert len(fcs) == len(ref_fcs)
    for fc, ref_fc in zip(fcs, ref_fcs):
        assert sorted(fc) == sorted(ref_fc)
        for name, ref_arr in ref_fc.items():
            arr, ref_arr = np.asarray(fc[name]), np.asarray(ref_arr)
            assert arr.dtype == ref_arr.dtype, name
            np.testing.assert_array_equal(arr, ref_arr, err_msg=name)


def test_worlds_show_what_they_test():
    """The reference outcomes the worlds are built to reach, read off the
    cached JAX runs the port is held to above."""
    out = {w: _reference(w, 1)[0] for w in ("wffc-zone", "dynamic-provisioning",
                                            "two-pods-race", "ghost-claim")}
    assert out["wffc-zone"][0]["key"][0][0][1] in ("n1", "n3")
    assert out["wffc-zone"][0]["storage"]["pvcs"]["default/data"][:2] == (
        "pv-1", "Bound")
    dyn = out["dynamic-provisioning"]
    assert not dyn[0]["key"][0] and dyn[1]["key"][0]
    assert dyn[1]["storage"]["pvcs"]["default/data"][0] == "pv-dyn"
    race = out["two-pods-race"]
    assert len(race[0]["key"][0]) == 1 and len(race[1]["key"][0]) == 1
    assert out["ghost-claim"][0]["reasons"] == [
        ("default/orphan", "persistentvolumeclaim not found")]
    # the fused dispatch carried real bound claims (hot columns), and the
    # storage layer's unbound claims on several pods demoted it
    bound = _reference("bound-claims", 4)[0]
    assert bound[0]["waves"] > 1 and bound[0]["demotions"] == []
    overflow = _reference("hot-claim-overflow", 4)[0]
    assert overflow[0]["demotions"] == ["claim-entangled"]
    layer = _reference("storage-layer", 4)[0]
    assert "claim-entangled" in layer[0]["demotions"]
    assert any(s[1] == "Bound" for s in layer[0]["storage"]["pvs"].values())


def _parity_state(pkg, synth):
    """tests/test_volumebinding.py test_wffc_parity_across_backends' state:
    zones over the nodes, WFFC claims on every third pod, PVs in two of
    the three zones."""
    _c, state = synth(6, 12, seed=11, num_gangs=0, num_quotas=0)
    for i, node in enumerate(state.nodes):
        node.meta.labels[ZONE_LABEL] = f"z{i % 3}"
    state.storage_classes = {"local": _sc(pkg)}
    for j, zone in enumerate(["z0", "z0", "z2"]):
        pv = _pv(pkg, f"pv-{j}", zone=zone)
        state.pvs[pv.meta.name] = pv
    for pod in state.pending_pods[::3]:
        name = f"claim-{pod.meta.name}"
        pvc = _pvc(pkg, name)
        pvc.meta.namespace = pod.meta.namespace
        state.pvcs[pvc.meta.key] = pvc
        pod.spec.pvc_names = [name]
    return state


def _budget_state(pkg, synth):
    """More admission signatures than the mask's bit budget: a zone per
    node, a bound zonal claim per pending pod. Both packages fold the
    excess nodes into the same groups (the overflow group admits
    nobody), so the mask never grows past its one f32 word."""
    _c, state = synth(30, 40, seed=3, num_gangs=0, num_quotas=0)
    for i, node in enumerate(state.nodes):
        node.meta.labels[ZONE_LABEL] = f"zone-{i}"
    for i, pod in enumerate(state.pending_pods):
        zone = f"zone-{i % len(state.nodes)}"
        pv = _pv(pkg, f"pv-{i}", zone=zone, sc="",
                 claim_ref=f"{pod.meta.namespace}/c-{i}")
        pvc = _pvc(pkg, f"c-{i}", sc="", volume=pv.meta.name)
        pvc.meta.namespace = pod.meta.namespace
        state.pvs[pv.meta.name] = pv
        state.pvcs[pvc.meta.key] = pvc
        pod.spec.pvc_names = [f"c-{i}"]
    return state


@pytest.mark.parametrize("maker", [_parity_state, _budget_state,
                                   _layer_state],
                         ids=["wffc-parity", "bit-budget", "storage-layer"])
def test_cold_pack_matches_reference(maker):
    fc = _assert_packs_equal(maker(REF, ref_synth),
                             maker(PORT, synth_full_cluster))
    mask = np.asarray(fc.pod_taint_mask)
    assert mask.dtype == np.float32 and (mask < 2 ** 24).all()
    if maker is _budget_state:
        from koordinator_tpu_torch.ops.taints import MAX_TAINT_GROUPS

        # the budget is full and no group id reaches past the mask's bits
        groups = np.asarray(fc.node_taint_group)
        assert len(np.unique(groups)) >= MAX_TAINT_GROUPS - 2
        assert groups.max() < MAX_TAINT_GROUPS
