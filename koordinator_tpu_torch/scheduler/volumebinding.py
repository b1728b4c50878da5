"""VolumeBinding analog: schedule-time PVC->PV matching and binding.

The reference wraps the stock kube-scheduler, which vendors the upstream
VolumeBinding plugin (registered via the upstream app in
reference cmd/koord-scheduler/main.go:43-62): PreFilter classifies a
pod's claims, Filter checks each candidate node can satisfy the unbound
WaitForFirstConsumer (WFFC) claims, Reserve assumes a concrete PV per
claim, and PreBind writes the PV/PVC bind patches (or triggers dynamic
provisioning and waits).

Batched shape: per-(pod, node) PV matching does not batch, but volume
*topology* does. A WFFC claim is satisfiable on a node iff the node's
topology labels cover some candidate PV's topology (static binding) or
some provisioner-allowed topology term (dynamic). That predicate is pure
host metadata, so it rides the existing admission-signature bitmask
(ops/taints.py `any_of_sets`) — the kernel still runs ONE bit test per
(pod, node) and every backend (the CUDA kernel, the plain round, the numpy
oracle) inherits the filter through the packed arrays, parity by
construction. Concrete PV selection happens once per actual binding at
Reserve (smallest-fit, upstream volume_binding's sort order), and the
PVC/PV patches land at PreBind.

Divergence, documented: where upstream PreBind blocks awaiting an
external dynamic provisioner, this analog annotates the claim with the
selected node and vetoes the binding — the pod retries next cycle and
binds as soon as the PV exists. Functionally equivalent, deadline-free,
and it keeps the cycle driver non-blocking.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from koordinator_tpu_torch.api.objects import (
    PersistentVolume,
    PersistentVolumeClaim,
    Pod,
    StorageClass,
)
from koordinator_tpu_torch.client.store import (
    KIND_NODE,
    KIND_PV,
    KIND_PVC,
    KIND_STORAGECLASS,
    EventType,
    ObjectStore,
)
from koordinator_tpu_torch.scheduler.frameworkext import CycleContext, Plugin

# upstream storage.k8s.io constants
NO_PROVISIONER = "kubernetes.io/no-provisioner"
WAIT_FOR_FIRST_CONSUMER = "WaitForFirstConsumer"
IMMEDIATE = "Immediate"
SELECTED_NODE_ANNOTATION = "volume.kubernetes.io/selected-node"

# upstream unschedulable status messages (volume_binding.go ErrReason*)
REASON_PVC_NOT_FOUND = "persistentvolumeclaim not found"
REASON_SC_NOT_FOUND = "storageclass not found"
REASON_UNBOUND_IMMEDIATE = "pod has unbound immediate PersistentVolumeClaims"
REASON_NO_MATCHING_PV = "no persistent volume matches the claim topology"


def _covers(capacity, request) -> bool:
    """PV capacity >= claim request on every requested quantity."""
    return all(capacity.get(k, 0) >= v for k, v in request.quantities.items())


def pv_available_for(pv: PersistentVolume, pvc_key: str) -> bool:
    """Static-binding candidate: unclaimed and Available, or already
    pre-bound to this very claim (upstream honors claimRef pre-binding)."""
    if pv.claim_ref:
        return pv.claim_ref == pvc_key
    return pv.phase == "Available"


def pv_matches_claim(pv: PersistentVolume, pvc: PersistentVolumeClaim) -> bool:
    return (pv.storage_class_name == pvc.storage_class_name
            and pv_available_for(pv, pvc.meta.key)
            and _covers(pv.capacity, pvc.capacity))


def _topology_alternatives(term) -> List[frozenset]:
    """Expand one allowedTopologies term — (key, values) requirements ANDed,
    values within a key ORed — into flat pair-set alternatives."""
    alts = [frozenset()]
    for key, values in term:
        alts = [alt | {(key, v)} for alt in alts for v in values]
    return alts


@dataclass
class PodVolumeClassification:
    """PreFilter output for one pod (upstream PodVolumes analog)."""

    # unbound WFFC claim keys needing a Reserve-time PV pick / provisioning
    wffc_claims: Tuple[str, ...] = ()
    # one element per TOPOLOGY-CONSTRAINED unbound claim: alternatives of
    # required (key, value) pair sets — rides admission_mask(any_of_sets=)
    any_of_sets: Tuple[frozenset, ...] = ()
    # hard PreFilter rejection (mask will be zero; this is the condition
    # reason surfaced on the pod)
    reason: Optional[str] = None


def index_pvs_by_class(
    pvs: Dict[str, PersistentVolume],
) -> Dict[str, List[PersistentVolume]]:
    """Per-storage-class candidate index, built once per snapshot so each
    classification scans only its class's volumes instead of every PV."""
    by_class: Dict[str, List[PersistentVolume]] = {}
    for pv in pvs.values():
        by_class.setdefault(pv.storage_class_name, []).append(pv)
    return by_class


def classify_pod_volumes(
    pod: Pod,
    pvcs: Dict[str, PersistentVolumeClaim],
    pvs: Dict[str, PersistentVolume],
    storage_classes: Dict[str, StorageClass],
    pvs_by_class: Optional[Dict[str, List[PersistentVolume]]] = None,
) -> PodVolumeClassification:
    """Classify the pod's claims the way upstream PreFilter does.

    Bound claims are out of scope here — their PV topology already rides
    the admission bitmask as required pairs (snapshot.volume_zone_pairs).
    """
    if pvs_by_class is None:
        pvs_by_class = index_pvs_by_class(pvs)
    wffc: List[str] = []
    any_of: List[frozenset] = []
    for claim in pod.spec.pvc_names:
        pvc_key = f"{pod.meta.namespace}/{claim}"
        pvc = pvcs.get(pvc_key)
        if pvc is None:
            return PodVolumeClassification(reason=REASON_PVC_NOT_FOUND)
        if pvc.is_bound:
            continue
        if not pvc.storage_class_name:
            # classless unbound claims belong to the async PV controller —
            # upstream treats them as unbound immediate
            return PodVolumeClassification(reason=REASON_UNBOUND_IMMEDIATE)
        sc = storage_classes.get(pvc.storage_class_name)
        if sc is None:
            return PodVolumeClassification(reason=REASON_SC_NOT_FOUND)
        if sc.volume_binding_mode != WAIT_FOR_FIRST_CONSUMER:
            return PodVolumeClassification(reason=REASON_UNBOUND_IMMEDIATE)
        wffc.append(claim)
        alternatives: set = set()
        unconstrained = False
        # static candidates: any matching Available PV's full topology
        # pair set is one alternative; a label-less PV fits every node
        for pv in pvs_by_class.get(pvc.storage_class_name, ()):
            if not pv_matches_claim(pv, pvc):
                continue
            zp = pv.zone_pairs()
            if not zp:
                unconstrained = True
                break
            alternatives.add(frozenset(zp))
        # dynamic provisioning: allowed everywhere (no term list) or on
        # nodes matching some allowedTopologies term
        if not unconstrained and sc.provisioner and sc.provisioner != NO_PROVISIONER:
            if not sc.allowed_topologies:
                unconstrained = True
            else:
                for term in sc.allowed_topologies:
                    alternatives.update(_topology_alternatives(term))
        if unconstrained:
            continue
        if not alternatives:
            # no PV anywhere and no provisioner: mask zeroes out and the
            # cycle surfaces this reason on the pod (upstream Filter fails
            # every node with the same message)
            return PodVolumeClassification(
                wffc_claims=tuple(wffc), reason=REASON_NO_MATCHING_PV)
        any_of.append(frozenset(alternatives))
    return PodVolumeClassification(
        wffc_claims=tuple(wffc), any_of_sets=tuple(any_of))


def any_of_pair_universe(any_of_sets: Sequence[frozenset]) -> frozenset:
    """All (key, value) pairs any alternative references — these must join
    the batch's selector pairs so node admission signatures encode them."""
    return frozenset(
        p for alts in any_of_sets for alt in alts for p in alt)


class VolumeBindingPlugin(Plugin):
    """Reserve/PreBind side of the analog (upstream Reserve assume-cache +
    PreBind BindPodVolumes). The per-cycle assumed set lives in the
    CycleContext so two pods in one batch never pick the same PV."""

    name = "VolumeBinding"

    def __init__(self) -> None:
        self._store: ObjectStore = None  # type: ignore[assignment]
        # _pick_pv's candidates: per storage class, (capacity, name, store
        # key) of every PV in pick order; None until rebuilt
        self._pv_order: Optional[Dict[str, List[Tuple[int, str, str]]]] = None

    def register(self, store: ObjectStore) -> None:
        self._store = store
        self._pv_order = None
        store.subscribe(KIND_PV, self._on_pv, replay=False)

    def _on_pv(self, event: EventType, pv: PersistentVolume,
               old: Optional[PersistentVolume]) -> None:
        """A bind rewrites a PV's claim and phase, never its class,
        capacity or name: the pick order holds. Anything else rebuilds
        it."""
        if (event == EventType.MODIFIED and old is not None
                and old.storage_class_name == pv.storage_class_name
                and old.capacity.quantities == pv.capacity.quantities):
            return
        self._pv_order = None

    # ------------------------------------------------------------------
    def _assumed(self, ctx: CycleContext) -> Dict[str, str]:
        return ctx.data.setdefault("volume_assumed", {})  # pv name -> pvc key

    def _decisions(self, ctx: CycleContext) -> Dict[str, List[Tuple[str, str]]]:
        return ctx.data.setdefault("volume_binds", {})  # pod key -> [(pvc, pv)]

    def reserve(self, pod: Pod, node_name: str,
                ctx: CycleContext) -> Optional[str]:
        if not pod.spec.pvc_names:
            return None
        # opaque-token mode (the SHARED volume-aware gate,
        # ops/volumes.py): pvc_names are CSI count tokens, nothing to
        # bind — Reserve must not veto them (a veto would make every
        # opaque claim pod an immortal queue resident). Cached per
        # cycle on the CycleContext: Reserve runs per binding.
        aware = ctx.data.get("volume_aware")
        if aware is None:
            from koordinator_tpu_torch.ops.volumes import store_volume_aware

            aware = ctx.data["volume_aware"] = store_volume_aware(
                self._store)
        if not aware:
            return None
        node = self._store.get(KIND_NODE, f"/{node_name}")
        node_labels = node.meta.labels if node is not None else {}
        assumed = self._assumed(ctx)
        picks: List[Tuple[str, str]] = []
        provisioning: List[PersistentVolumeClaim] = []
        for claim in pod.spec.pvc_names:
            pvc_key = f"{pod.meta.namespace}/{claim}"
            pvc = self._store.get(KIND_PVC, pvc_key)
            if pvc is None:
                self._release(ctx, picks)
                return REASON_PVC_NOT_FOUND
            if pvc.is_bound:
                continue
            sc = self._class_of(pvc)
            if sc is None or sc.volume_binding_mode != WAIT_FOR_FIRST_CONSUMER:
                self._release(ctx, picks)
                return REASON_UNBOUND_IMMEDIATE
            pv = self._pick_pv(pvc, node_labels, assumed)
            if pv is not None:
                assumed[pv.meta.name] = pvc_key
                picks.append((pvc_key, pv.meta.name))
                continue
            if sc.provisioner and sc.provisioner != NO_PROVISIONER:
                provisioning.append(pvc)
                continue
            self._release(ctx, picks)
            return f"{REASON_NO_MATCHING_PV} on node"
        if provisioning:
            # upstream PreBind triggers the provisioner (selected-node
            # annotation) and blocks; the analog annotates and retries the
            # pod next cycle — see module docstring
            self._release(ctx, picks)
            for pvc in provisioning:
                if pvc.meta.annotations.get(SELECTED_NODE_ANNOTATION) != node_name:
                    # patch a COPY: watch subscribers diff old vs new
                    # (the DefaultPreBind discipline)
                    patched = copy.deepcopy(pvc)
                    patched.meta.annotations[SELECTED_NODE_ANNOTATION] = node_name
                    self._store.update(KIND_PVC, patched)
            return "waiting for volume provisioning"
        if picks:
            self._decisions(ctx)[pod.meta.key] = picks
        return None

    def unreserve(self, pod: Pod, node_name: str, ctx: CycleContext) -> None:
        picks = self._decisions(ctx).pop(pod.meta.key, None)
        if picks:
            self._release(ctx, picks)

    def pre_bind(self, pod: Pod, node_name: str, ctx: CycleContext,
                 annotations: Dict[str, str]) -> None:
        """Write the PV/PVC bind patches. The reference's volume binder
        issues its own PV/PVC API patches in PreBind, separate from the
        single pod patch — mirrored here as direct store updates."""
        picks = self._decisions(ctx).pop(pod.meta.key, None)
        if not picks:
            return
        for pvc_key, pv_name in picks:
            pvc = self._store.get(KIND_PVC, pvc_key)
            pv = self._pv_by_name(pv_name)
            if pvc is None or pv is None:
                continue
            pv = copy.deepcopy(pv)
            pv.claim_ref = pvc_key
            pv.phase = "Bound"
            self._store.update(KIND_PV, pv)
            pvc = copy.deepcopy(pvc)
            pvc.volume_name = pv_name
            pvc.phase = "Bound"
            self._store.update(KIND_PVC, pvc)
            self._assumed(ctx).pop(pv_name, None)

    # ------------------------------------------------------------------
    def _class_of(self, pvc: PersistentVolumeClaim) -> Optional[StorageClass]:
        if not pvc.storage_class_name:
            return None
        # cluster-scoped objects key as "/name" (namespace ""); fall back
        # to a scan for stores populated with a nonempty namespace
        sc = self._store.get(KIND_STORAGECLASS, f"/{pvc.storage_class_name}")
        if sc is not None:
            return sc
        for sc in self._store.list(KIND_STORAGECLASS):
            if sc.meta.name == pvc.storage_class_name:
                return sc
        return None

    def _pv_by_name(self, name: str) -> Optional[PersistentVolume]:
        pv = self._store.get(KIND_PV, f"/{name}")
        if pv is not None:
            return pv
        for pv in self._store.list(KIND_PV):
            if pv.meta.name == name:
                return pv
        return None

    def _pick_pv(self, pvc: PersistentVolumeClaim, node_labels: Dict[str, str],
                 assumed: Dict[str, str]) -> Optional[PersistentVolume]:
        """Smallest matching PV whose topology the node satisfies (upstream
        volume_binding FindMatchingVolume: smallest capacity, then name).
        The claim's class's PVs are walked in (capacity, name) order, so
        the first match is the smallest: the JAX package's scan over every
        PV, without visiting the rest."""
        order = self._pv_order
        if order is None:
            order = {}
            for pv in self._store.list(KIND_PV):
                order.setdefault(pv.storage_class_name, []).append(
                    (sum(pv.capacity.quantities.values()), pv.meta.name,
                     pv.meta.key))
            for cands in order.values():
                cands.sort()
            self._pv_order = order
        for _capacity, name, key in order.get(pvc.storage_class_name, ()):
            if name in assumed and assumed[name] != pvc.meta.key:
                continue
            pv = self._store.get(KIND_PV, key)
            if pv is None or not pv_matches_claim(pv, pvc):
                continue
            if any(node_labels.get(k) != v for k, v in pv.zone_pairs()):
                continue
            return pv
        return None

    def _release(self, ctx: CycleContext, picks: List[Tuple[str, str]]) -> None:
        assumed = self._assumed(ctx)
        for _pvc_key, pv_name in picks:
            assumed.pop(pv_name, None)
