"""CRD-like object model.

Python analogs of the reference's API types — core k8s objects (Pod, Node) plus the
ten koordinator CRDs installed from `config/crd/bases/` (SURVEY.md section 2.7):
NodeMetric, NodeSLO, Reservation, Device, PodGroup, ElasticQuota, PodMigrationJob,
ClusterColocationProfile, NodeResourceTopology, ElasticQuotaProfile.

These are deliberately plain dataclasses: the control plane manipulates them on host;
`ops/packing.py` lowers snapshots of them into device tensors. Field names follow the
reference's json tags so traces serialize compatibly. Durable state is externalized
into these objects exactly as in the reference (SURVEY.md section 5.4): restart =
re-list + rebuild caches.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field, replace
from typing import Any, Dict, List, Optional, Tuple

from koordinator_tpu_torch.api.priority import (
    PriorityClass,
    priority_class_by_name,
    priority_class_by_value,
)
from koordinator_tpu_torch.api.qos import QoSClass, qos_class_by_name
from koordinator_tpu_torch.api.resources import ResourceList

# Well-known labels/annotations (reference apis/extension/constants.go:21-47 and
# plugin-specific files; cited per constant).
DOMAIN_PREFIX = "koordinator.sh/"
SCHEDULING_DOMAIN_PREFIX = "scheduling.koordinator.sh"
NODE_DOMAIN_PREFIX = "node.koordinator.sh"
POD_DOMAIN_PREFIX = "pod.koordinator.sh"
QUOTA_DOMAIN_PREFIX = "quota.scheduling.koordinator.sh"

LABEL_POD_QOS = DOMAIN_PREFIX + "qosClass"                      # constants.go:31
LABEL_POD_PRIORITY = DOMAIN_PREFIX + "priority"                 # constants.go:32
LABEL_POD_PRIORITY_CLASS = DOMAIN_PREFIX + "priority-class"     # constants.go:36
LABEL_POD_GROUP = "pod-group.scheduling.sigs.k8s.io"            # coscheduling
ANNOTATION_RESOURCE_SPEC = SCHEDULING_DOMAIN_PREFIX + "/resource-spec"
ANNOTATION_RESOURCE_STATUS = SCHEDULING_DOMAIN_PREFIX + "/resource-status"
ANNOTATION_DEVICE_ALLOCATED = SCHEDULING_DOMAIN_PREFIX + "/device-allocated"
ANNOTATION_RESERVATION_ALLOCATED = SCHEDULING_DOMAIN_PREFIX + "/reservation-allocated"
ANNOTATION_EXTENDED_RESOURCE_SPEC = NODE_DOMAIN_PREFIX + "/extended-resource-spec"
# marks the fake pods the scheduler itself creates for Reservation CRs; user
# pods may never carry it (pkg/util/reservation/reservation.go:44, enforced
# by webhook pod/validating/verify_annotations.go:60-76)
ANNOTATION_RESERVE_POD = SCHEDULING_DOMAIN_PREFIX + "/reserve-pod"
# node-level resource reservation for system daemons
# (apis/extension/node_reservation.go:28-44): {"resources": {...},
# "reservedCPUs": "1-6", "applyPolicy": "Default"|"ReservedCPUsOnly"}
ANNOTATION_NODE_RESERVATION = NODE_DOMAIN_PREFIX + "/reservation"
# CPU cores dedicated to SYSTEM QoS pods (apis/extension/system_qos.go:24):
# {"cpuset": "0-1", "cpusetExclusive": true} — exclusive (the default) bars
# LS/LSR/BE pods from those cores
ANNOTATION_NODE_SYSTEM_QOS = NODE_DOMAIN_PREFIX + "/system-qos-resource"
# koordwatch decision correlation (obs/timeline.py): the device-window
# decision id a PodMigrationJob was issued under, copied onto its
# replacement Reservation — joins descheduler decisions to scheduler
# timeline windows, spans and flight records
ANNOTATION_DECISION_ID = DOMAIN_PREFIX + "decision-id"
# pod operating mode (apis/extension/operating_pod.go:28-50): a pod labeled
# "Reservation" schedules normally but then acts as a reservation whose
# owners (JSON ReservationOwner list annotation) consume its resources
LABEL_POD_OPERATING_MODE = SCHEDULING_DOMAIN_PREFIX + "/operating-mode"
ANNOTATION_RESERVATION_OWNERS = (
    SCHEDULING_DOMAIN_PREFIX + "/reservation-owners")
ANNOTATION_RESERVATION_CURRENT_OWNER = (
    SCHEDULING_DOMAIN_PREFIX + "/reservation-current-owner")
LABEL_QUOTA_NAME = QUOTA_DOMAIN_PREFIX + "/name"
LABEL_QUOTA_PARENT = QUOTA_DOMAIN_PREFIX + "/parent"
LABEL_QUOTA_IS_PARENT = QUOTA_DOMAIN_PREFIX + "/is-parent"
LABEL_QUOTA_SHARED_WEIGHT = QUOTA_DOMAIN_PREFIX + "/shared-weight"
LABEL_QUOTA_TREE_ID = QUOTA_DOMAIN_PREFIX + "/tree-id"
LABEL_QUOTA_ALLOW_LENT = QUOTA_DOMAIN_PREFIX + "/allow-lent-resource"
ANNOTATION_QUOTA_GUARANTEED = QUOTA_DOMAIN_PREFIX + "/guaranteed"


@dataclass
class ObjectMeta:
    name: str = ""
    namespace: str = "default"
    uid: str = ""
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    creation_timestamp: float = field(default_factory=time.time)
    resource_version: int = 0
    deletion_timestamp: Optional[float] = None
    owner_kind: str = ""
    owner_name: str = ""

    @property
    def key(self) -> str:
        # memoized: the packed-snapshot path reads keys tens of thousands
        # of times per cycle. Identity-checked against name/namespace so a
        # rebound field (tests mutate metas in place) recomputes.
        cached = self.__dict__.get("_key_memo")
        if (cached is not None and cached[0] is self.name
                and cached[1] is self.namespace):
            return cached[2]
        k = f"{self.namespace}/{self.name}"
        self.__dict__["_key_memo"] = (self.name, self.namespace, k)
        return k


@dataclass
class PodAffinityTerm:
    """requiredDuringSchedulingIgnoredDuringExecution inter-pod (anti-)
    affinity term: pods matching `selector` within the `topology_key`
    domain of a candidate node (core/v1 PodAffinityTerm, matchLabels
    form — the form the vendored kube-scheduler InterPodAffinity plugin
    evaluates in Filter)."""

    selector: Dict[str, str] = field(default_factory=dict)
    topology_key: str = "kubernetes.io/hostname"
    # namespaces the selector applies to; empty means the OWNING pod's own
    # namespace (core/v1 PodAffinityTerm.namespaces default)
    namespaces: List[str] = field(default_factory=list)


@dataclass
class PreferredPodTerm:
    """preferredDuringSchedulingIgnoredDuringExecution inter-pod affinity
    (core/v1 WeightedPodAffinityTerm, matchLabels form): candidate nodes
    gain `weight` per matching pod in their topology domain. Negative
    weight expresses preferred ANTI-affinity."""

    weight: int = 1
    selector: Dict[str, str] = field(default_factory=dict)
    topology_key: str = "kubernetes.io/hostname"
    namespaces: List[str] = field(default_factory=list)


@dataclass
class TopologySpreadConstraint:
    """core/v1 TopologySpreadConstraint (matchLabels form), evaluated by
    the vendored PodTopologySpread plugin. whenUnsatisfiable=DoNotSchedule
    filters: placing the pod in a domain must keep count(domain) + 1 -
    min(eligible domain counts) <= max_skew. ScheduleAnyway only scores:
    emptier domains rank higher (a -1 weight on the constraint's own term
    in the preferred-affinity machinery)."""

    max_skew: int = 1
    topology_key: str = "kubernetes.io/hostname"
    selector: Dict[str, str] = field(default_factory=dict)
    when_unsatisfiable: str = "DoNotSchedule"


@dataclass
class PreferredNodeTerm:
    """preferredDuringSchedulingIgnoredDuringExecution node affinity term
    (core/v1 PreferredSchedulingTerm, matchLabels form): nodes matching
    `labels` gain `weight` in the NodeAffinity score."""

    weight: int = 1
    labels: Dict[str, str] = field(default_factory=dict)


@dataclass
class PodSpec:
    node_name: str = ""
    scheduler_name: str = "koord-scheduler"
    priority: Optional[int] = None
    priority_class_name: str = ""
    requests: ResourceList = field(default_factory=ResourceList)
    limits: ResourceList = field(default_factory=ResourceList)
    node_selector: Dict[str, str] = field(default_factory=dict)
    affinity_required_node_labels: Dict[str, str] = field(default_factory=dict)
    affinity_preferred: List["PreferredNodeTerm"] = field(default_factory=list)
    pod_affinity: List["PodAffinityTerm"] = field(default_factory=list)
    pod_anti_affinity: List["PodAffinityTerm"] = field(default_factory=list)
    pod_affinity_preferred: List["PreferredPodTerm"] = field(
        default_factory=list)
    topology_spread: List["TopologySpreadConstraint"] = field(
        default_factory=list)
    tolerations: List[Tuple[str, str]] = field(default_factory=list)  # (key, value)
    overhead: ResourceList = field(default_factory=ResourceList)
    restart_policy: str = "Always"
    termination_grace_period_seconds: int = 30
    # container hostPorts as (protocol, port) — the vendored NodePorts
    # filter's conflict identity (hostIP treated as the 0.0.0.0 wildcard:
    # conservative, a conflict on any IP blocks the node)
    host_ports: List[Tuple[str, int]] = field(default_factory=list)
    # PVC claim names the pod mounts (volumes[].persistentVolumeClaim) —
    # drive the CSI volume-limit count and the VolumeZone filter
    pvc_names: List[str] = field(default_factory=list)
    # container images — the vendored ImageLocality score reads them
    # against node.images
    images: List[str] = field(default_factory=list)
    # desired requests of a PENDING in-place resize (KEP-1287 shape; the
    # frameworkext ResizePod path consumes it when the feature gate is on:
    # reference frameworkext_factory RunReservePluginsReserve+RunResizePod)
    resize_requests: Optional[ResourceList] = None


@dataclass
class PodCondition:
    """core v1 PodCondition subset: the scheduler writes PodScheduled
    (status False / reason Unschedulable / message with the per-stage
    breakdown) when a pod ends a cycle unbound, and flips it True at bind —
    the same status surface the scheduler framework propagates upstream."""

    type: str = "PodScheduled"
    status: str = "False"  # "True" | "False"
    reason: str = ""
    message: str = ""
    last_transition_time: float = 0.0


@dataclass
class Pod:
    meta: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodSpec = field(default_factory=PodSpec)
    phase: str = "Pending"  # Pending/Running/Succeeded/Failed
    reason: str = ""        # status.reason (e.g. "OutOfCpu", "NodeShutdown")
    restart_count: int = 0  # sum of container restart counts
    conditions: List[PodCondition] = field(default_factory=list)

    def get_condition(self, ctype: str) -> Optional[PodCondition]:
        for c in self.conditions:
            if c.type == ctype:
                return c
        return None

    def set_condition(self, ctype: str, status: str, reason: str,
                      message: str, now: float) -> bool:
        """Upsert a condition; returns True when anything changed.
        last_transition_time bumps only on a STATUS flip (upstream
        semantics), so repeated identical writes are no-ops the caller can
        skip persisting."""
        cur = self.get_condition(ctype)
        if cur is None:
            self.conditions.append(PodCondition(
                type=ctype, status=status, reason=reason, message=message,
                last_transition_time=now))
            return True
        if (cur.status, cur.reason, cur.message) == (status, reason, message):
            return False
        if cur.status != status:
            cur.last_transition_time = now
        cur.status, cur.reason, cur.message = status, reason, message
        return True

    @property
    def qos_class(self) -> QoSClass:
        """QoS from the koordinator.sh/qosClass label (apis/extension/qos.go)."""
        return qos_class_by_name(self.meta.labels.get(LABEL_POD_QOS, ""))

    @property
    def is_reservation_operating_mode(self) -> bool:
        """operating_pod.go IsReservationOperatingMode."""
        return self.meta.labels.get(LABEL_POD_OPERATING_MODE) == "Reservation"

    def reservation_owners(self) -> List["ReservationOwner"]:
        """Parse the reservation-owners annotation (operating_pod.go
        SetReservationOwners): a JSON list of ReservationOwner objects; both
        the full {"labelSelector": {"matchLabels": {...}}} form and a flat
        {"labelSelector": {...}} shorthand are accepted. Malformed
        annotations yield no owners (the reservation matches nothing)."""
        import json

        raw = self.meta.annotations.get(ANNOTATION_RESERVATION_OWNERS)
        if not raw:
            return []
        try:
            data = json.loads(raw)
            if not isinstance(data, list):
                return []
            owners = []
            for entry in data:
                if not isinstance(entry, dict):
                    continue
                sel = entry.get("labelSelector") or {}
                if isinstance(sel, dict) and isinstance(
                        sel.get("matchLabels"), dict):
                    sel = sel["matchLabels"]
                if not isinstance(sel, dict):
                    continue
                owners.append(ReservationOwner(
                    label_selector={str(k): str(v) for k, v in sel.items()},
                    controller_kind=str(entry.get("controllerKind", "")),
                    controller_name=str(entry.get("controllerName", "")),
                    namespace=str(entry.get("namespace", "")),
                ))
            return owners
        except (ValueError, TypeError):
            return []

    @property
    def priority_class(self) -> PriorityClass:
        """Label override first, then numeric band (priority.go:74-84)."""
        if LABEL_POD_PRIORITY_CLASS in self.meta.labels:
            return priority_class_by_name(self.meta.labels[LABEL_POD_PRIORITY_CLASS])
        return priority_class_by_value(self.spec.priority)

    @property
    def sub_priority(self) -> int:
        """koordinator.sh/priority label (priority.go:107-116)."""
        try:
            return int(self.meta.labels.get(LABEL_POD_PRIORITY, "0") or "0")
        except ValueError:
            return 0

    def patch_copy(self) -> "Pod":
        """Cheap copy for store patches: fresh Pod/meta/spec objects with
        fresh copies of every MUTABLE container (label/annotation/selector
        dicts, ResourceLists, tolerations) — the store's update path runs the
        admission webhook, which mutates those in place, so they must not
        alias the old stored object or watch subscribers would see old==new.
        Scalar leaves are shared. A full deepcopy here was the scheduler's
        dominant host cost at 10k bindings per cycle."""
        spec = self.spec
        return replace(
            self,
            meta=replace(
                self.meta,
                labels=dict(self.meta.labels),
                annotations=dict(self.meta.annotations),
            ),
            spec=replace(
                spec,
                requests=spec.requests.copy(),
                limits=spec.limits.copy(),
                node_selector=dict(spec.node_selector),
                affinity_required_node_labels=dict(
                    spec.affinity_required_node_labels
                ),
                affinity_preferred=[
                    replace(t, labels=dict(t.labels))
                    for t in spec.affinity_preferred
                ],
                pod_affinity=[
                    replace(t, selector=dict(t.selector),
                            namespaces=list(t.namespaces))
                    for t in spec.pod_affinity
                ],
                pod_anti_affinity=[
                    replace(t, selector=dict(t.selector),
                            namespaces=list(t.namespaces))
                    for t in spec.pod_anti_affinity
                ],
                pod_affinity_preferred=[
                    replace(t, selector=dict(t.selector),
                            namespaces=list(t.namespaces))
                    for t in spec.pod_affinity_preferred
                ],
                topology_spread=[
                    replace(c, selector=dict(c.selector))
                    for c in spec.topology_spread
                ],
                tolerations=list(spec.tolerations),
                overhead=spec.overhead.copy(),
            ),
            conditions=[replace(c) for c in self.conditions],
        )

    @property
    def gang_name(self) -> str:
        return self.meta.labels.get(LABEL_POD_GROUP, "")

    @property
    def gang_key(self) -> str:
        """Namespaced gang identity: the pod-group label names a PodGroup in
        the POD's namespace (coscheduling core.go GetGangFullName), so two
        same-named gangs in different namespaces never collide."""
        name = self.meta.labels.get(LABEL_POD_GROUP, "")
        return f"{self.meta.namespace}/{name}" if name else ""

    @property
    def quota_name(self) -> str:
        return self.meta.labels.get(LABEL_QUOTA_NAME, "")

    @property
    def is_assigned(self) -> bool:
        return bool(self.spec.node_name)

    @property
    def is_terminated(self) -> bool:
        return self.phase in ("Succeeded", "Failed")

    @property
    def is_healthy(self) -> bool:
        """policy/v1 currentHealthy counts pods with the Ready condition;
        here that means scheduled and Running — a Pending/unassigned pod must
        NOT shore up a PodDisruptionBudget (disruption controller,
        pkg/controller/disruption in upstream k8s)."""
        return self.is_assigned and self.phase == "Running"


@dataclass
class Node:
    meta: ObjectMeta = field(default_factory=ObjectMeta)
    allocatable: ResourceList = field(default_factory=ResourceList)
    capacity: ResourceList = field(default_factory=ResourceList)
    unschedulable: bool = False
    taints: List[Tuple[str, str]] = field(default_factory=list)  # (key, value)
    ready: bool = True
    # node.status.images as image name -> sizeBytes (ImageLocality score)
    images: Dict[str, int] = field(default_factory=dict)
    # CSI attachable-volume limit (node.status.allocatable
    # attachable-volumes-csi-*); 0 = no limit reported
    attachable_volume_limit: int = 0

    def node_reservation(self):
        """(reserved ResourceList, reserved_cpus str, trims_allocatable) from
        the node-reservation annotation (apis/extension/node_reservation.go
        GetNodeReservation + pkg/util/node.go GetNodeReservationResources):
        reservedCPUs overrides the cpu quantity with the cpuset's core count;
        applyPolicy Default (or empty) trims schedulable allocatable,
        ReservedCPUsOnly reserves the cores without trimming. Malformed
        annotations reserve nothing (the reference logs and returns nil)."""
        raw = self.meta.annotations.get(ANNOTATION_NODE_RESERVATION)
        empty = ResourceList()
        if not raw:
            return empty, "", False
        import json

        from koordinator_tpu_torch.api.resources import parse_quantity

        try:
            data = json.loads(raw)
            if not isinstance(data, dict):
                return empty, "", False
            resources = data.get("resources")
            if not isinstance(resources, dict):
                resources = {}
            reserved = ResourceList()
            for name, qty in resources.items():
                reserved.quantities[name] = parse_quantity(
                    str(qty), cpu=(name == "cpu"))
            cpus = str(data.get("reservedCPUs") or "")
            if cpus:
                from koordinator_tpu_torch.utils.cpuset import CPUSet

                reserved.quantities["cpu"] = len(CPUSet.parse(cpus)) * 1000
            policy = data.get("applyPolicy") or "Default"
            return reserved, cpus, policy == "Default"
        except (ValueError, TypeError):
            return empty, "", False

    def system_qos_resource(self):
        """(cpuset str, exclusive bool) from the system-qos-resource
        annotation (apis/extension/system_qos.go GetSystemQOSResource):
        exclusive defaults to True; malformed annotations yield no cpuset."""
        raw = self.meta.annotations.get(ANNOTATION_NODE_SYSTEM_QOS)
        if not raw:
            return "", True
        import json

        try:
            data = json.loads(raw)
            if not isinstance(data, dict):
                return "", True
            cpuset = str(data.get("cpuset") or "")
            if cpuset:
                from koordinator_tpu_torch.utils.cpuset import CPUSet

                CPUSet.parse(cpuset)  # malformed -> reserve nothing
            exclusive = data.get("cpusetExclusive")
            return cpuset, exclusive is None or bool(exclusive)
        except (ValueError, TypeError):
            return "", True


# ---------------------------------------------------------------------------
# NodeMetric CR (apis/slo/v1alpha1/nodemetric_types.go)
# ---------------------------------------------------------------------------


@dataclass
class PodMetricInfo:
    namespace: str = ""
    name: str = ""
    pod_usage: ResourceList = field(default_factory=ResourceList)
    priority_class: PriorityClass = PriorityClass.NONE


@dataclass
class NodeMetricInfo:
    node_usage: ResourceList = field(default_factory=ResourceList)
    # {duration_seconds: {"p95"|"p99"|"avg"|...: ResourceList}}
    aggregated_node_usages: Dict[int, Dict[str, ResourceList]] = field(
        default_factory=dict
    )
    # usage of system daemons outside pod cgroups
    system_usage: ResourceList = field(default_factory=ResourceList)


@dataclass
class NodeMetric:
    """Measured node utilization, reported by koordlet on an interval
    (statesinformer/impl/states_nodemetric.go:182-210) and consumed by LoadAware,
    LowNodeLoad, and the noderesource controller."""

    meta: ObjectMeta = field(default_factory=ObjectMeta)
    update_time: float = 0.0
    node_metric: NodeMetricInfo = field(default_factory=NodeMetricInfo)
    pods_metric: List[PodMetricInfo] = field(default_factory=list)
    prod_reclaimable: ResourceList = field(default_factory=ResourceList)
    report_interval_seconds: int = 60
    aggregate_durations: List[int] = field(default_factory=lambda: [300, 900, 1800])


# ---------------------------------------------------------------------------
# Reservation CR (apis/scheduling/v1alpha1/reservation_types.go)
# ---------------------------------------------------------------------------


@dataclass
class ReservationOwner:
    """Owner matcher: label selector and/or controller reference
    (reservation_types.go ReservationOwner)."""

    label_selector: Dict[str, str] = field(default_factory=dict)
    controller_kind: str = ""
    controller_name: str = ""
    namespace: str = ""

    def matches(self, pod: Pod) -> bool:
        """All specified criteria must match (conjunction); an owner with no
        criteria matches every pod (reference ReservationOwnerMatcher.Match,
        pkg/util/reservation/reservation.go:402-409)."""
        if self.namespace and pod.meta.namespace != self.namespace:
            return False
        for k, v in self.label_selector.items():
            if pod.meta.labels.get(k) != v:
                return False
        if self.controller_kind and pod.meta.owner_kind != self.controller_kind:
            return False
        if self.controller_name and pod.meta.owner_name != self.controller_name:
            return False
        return True


@dataclass
class Reservation:
    """A resource pre-claim scheduled like a pod; matching pods later consume its
    reserved resources (pkg/scheduler/plugins/reservation/)."""

    meta: ObjectMeta = field(default_factory=ObjectMeta)
    template: PodSpec = field(default_factory=PodSpec)
    owners: List[ReservationOwner] = field(default_factory=list)
    ttl_seconds: Optional[int] = None
    expires_at: Optional[float] = None
    allocate_once: bool = True
    # status
    phase: str = "Pending"  # Pending/Available/Succeeded/Failed
    node_name: str = ""
    allocatable: ResourceList = field(default_factory=ResourceList)
    allocated: ResourceList = field(default_factory=ResourceList)
    current_owners: List[str] = field(default_factory=list)  # pod keys
    # set when this entry mirrors an operating-mode POD (operating_pod.go
    # ReservationPodOperatingMode) instead of a Reservation CR: the pod's
    # lifecycle governs it and no CR exists in the store
    from_pod_key: str = ""

    @property
    def is_available(self) -> bool:
        return self.phase == "Available" and bool(self.node_name)

    def is_expired(self, now: Optional[float] = None) -> bool:
        now = time.time() if now is None else now
        if self.expires_at is not None:
            return now >= self.expires_at
        if self.ttl_seconds is not None:
            return now >= self.meta.creation_timestamp + self.ttl_seconds
        return False

    def matches(self, pod: Pod) -> bool:
        return any(o.matches(pod) for o in self.owners)


# ---------------------------------------------------------------------------
# PodGroup CR (sigs.k8s.io scheme; plugins/coscheduling)
# ---------------------------------------------------------------------------


@dataclass
class PodGroup:
    meta: ObjectMeta = field(default_factory=ObjectMeta)
    min_member: int = 1
    schedule_timeout_seconds: int = 0  # 0 = use CoschedulingArgs.defaultTimeout
    # status
    phase: str = "Pending"
    scheduled: int = 0


# ---------------------------------------------------------------------------
# ElasticQuota CR (sigs.k8s.io scheme; plugins/elasticquota)
# ---------------------------------------------------------------------------


@dataclass
class ElasticQuota:
    meta: ObjectMeta = field(default_factory=ObjectMeta)
    min: ResourceList = field(default_factory=ResourceList)
    max: ResourceList = field(default_factory=ResourceList)

    @property
    def parent(self) -> str:
        return self.meta.labels.get(LABEL_QUOTA_PARENT, "")

    @property
    def is_parent(self) -> bool:
        return self.meta.labels.get(LABEL_QUOTA_IS_PARENT, "false") == "true"

    @property
    def shared_weight(self) -> ResourceList:
        """Fair-sharing weight; falls back to spec.max on missing/invalid/zero
        annotation (reference apis/extension/elastic_quota.go:89-99). Values are
        k8s quantity strings."""
        import json

        from koordinator_tpu_torch.api.resources import ResourceName, parse_quantity

        raw = self.meta.annotations.get(LABEL_QUOTA_SHARED_WEIGHT)
        if raw:
            try:
                data = json.loads(raw)
                if isinstance(data, dict):
                    parsed = {
                        k: parse_quantity(v, cpu=(k == ResourceName.CPU))
                        for k, v in data.items()
                    }
                    if parsed and all(v > 0 for v in parsed.values()):
                        return ResourceList(parsed)
            except (ValueError, TypeError):
                pass
        return self.max.copy()

    @property
    def allow_lent_resource(self) -> bool:
        """Whether unused min may be lent to siblings
        (apis/extension/elastic_quota.go:70-72: anything but "false")."""
        return self.meta.labels.get(LABEL_QUOTA_ALLOW_LENT, "") != "false"

    @property
    def guaranteed(self) -> ResourceList:
        """Floor the runtime never drops below
        (apis/extension/elastic_quota.go:150-157)."""
        import json

        from koordinator_tpu_torch.api.resources import ResourceName, parse_quantity

        raw = self.meta.annotations.get(ANNOTATION_QUOTA_GUARANTEED)
        if raw:
            try:
                data = json.loads(raw)
                if isinstance(data, dict):
                    return ResourceList({
                        k: parse_quantity(v, cpu=(k == ResourceName.CPU))
                        for k, v in data.items()
                    })
            except (ValueError, TypeError):
                pass
        return ResourceList()

    @property
    def tree_id(self) -> str:
        return self.meta.labels.get(LABEL_QUOTA_TREE_ID, "")


# ---------------------------------------------------------------------------
# Device CR (apis/scheduling/v1alpha1/device_types.go)
# ---------------------------------------------------------------------------


@dataclass
class DeviceInfo:
    type: str = "gpu"  # gpu | rdma | fpga
    uuid: str = ""
    minor: int = 0
    health: bool = True
    resources: ResourceList = field(default_factory=ResourceList)
    numa_node: int = -1


@dataclass
class Device:
    """Per-node device inventory reported by koordlet's device collectors."""

    meta: ObjectMeta = field(default_factory=ObjectMeta)  # name == node name
    devices: List[DeviceInfo] = field(default_factory=list)


# ---------------------------------------------------------------------------
# PersistentVolumeClaim (core v1 subset consumed by the PVC informer)
# ---------------------------------------------------------------------------


@dataclass
class PersistentVolumeClaim:
    """Subset of core v1 PVC: the koordlet pvc informer needs the
    namespace/name -> bound volume name mapping (reference
    pkg/koordlet/statesinformer/impl/states_pvc.go:44-60); the scheduler's
    VolumeBinding analog (scheduler/volumebinding.py) additionally reads
    the storage class and requested capacity of unbound claims."""

    meta: ObjectMeta = field(default_factory=ObjectMeta)
    volume_name: str = ""  # spec.volumeName once bound
    # for a bound claim this is status.capacity; for an unbound claim it is
    # spec.resources.requests (what a matching PV must cover)
    capacity: ResourceList = field(default_factory=ResourceList)
    storage_class_name: str = ""  # spec.storageClassName ("" = classless)
    phase: str = ""  # "", "Pending", "Bound" — volume_name wins when set

    @property
    def is_bound(self) -> bool:
        return bool(self.volume_name)


@dataclass
class PersistentVolume:
    """Subset of core v1 PV for the VolumeZone filter and the VolumeBinding
    analog: a PV carrying zone/region topology labels restricts pods
    mounting its claims to matching nodes (the vendored kube-scheduler
    VolumeZone plugin the reference inherits via
    cmd/koord-scheduler/main.go:53-62's upstream app); an Available PV is a
    static-binding candidate for unbound WaitForFirstConsumer claims
    (upstream VolumeBinding, same vendoring)."""

    meta: ObjectMeta = field(default_factory=ObjectMeta)
    capacity: ResourceList = field(default_factory=ResourceList)
    storage_class_name: str = ""
    claim_ref: str = ""  # "namespace/name" of the bound claim once bound
    phase: str = "Available"  # Available | Bound | Released

    ZONE_LABELS = ("topology.kubernetes.io/zone",
                   "topology.kubernetes.io/region",
                   "failure-domain.beta.kubernetes.io/zone",
                   "failure-domain.beta.kubernetes.io/region")

    def zone_pairs(self) -> List[Tuple[str, str]]:
        return [(k, v) for k, v in self.meta.labels.items()
                if k in self.ZONE_LABELS]


@dataclass
class StorageClass:
    """storage.k8s.io/v1 StorageClass subset for volume binding: the
    volumeBindingMode decides whether an unbound claim blocks scheduling
    (Immediate — the async PV controller owns it) or binds at schedule time
    (WaitForFirstConsumer), and allowedTopologies restricts where a dynamic
    provisioner may create volumes. Cluster-scoped: namespace is ""."""

    meta: ObjectMeta = field(default_factory=ObjectMeta)
    provisioner: str = ""
    volume_binding_mode: str = "Immediate"  # or "WaitForFirstConsumer"
    # allowedTopologies: each term is a tuple of (key, allowed values)
    # requirements ANDed together; terms are ORed (core v1
    # TopologySelectorTerm.matchLabelExpressions)
    allowed_topologies: List[Tuple[Tuple[str, Tuple[str, ...]], ...]] = field(
        default_factory=list)


# ---------------------------------------------------------------------------
# NodeSLO CR (apis/slo/v1alpha1/nodeslo_types.go)
# ---------------------------------------------------------------------------


@dataclass
class ResourceThresholdStrategy:
    """resourceUsedThresholdWithBE: drives cpusuppress/evict
    (qosmanager/plugins/cpusuppress)."""

    enable: bool = False
    cpu_suppress_threshold_percent: int = 65
    cpu_suppress_policy: str = "cpuset"  # cpuset | cfsQuota
    memory_evict_threshold_percent: int = 70
    memory_evict_lower_percent: Optional[int] = None
    cpu_evict_be_usage_threshold_percent: int = 90


@dataclass
class ResourceQOSStrategy:
    """Per-QoS-class cgroup knobs (group identity, memory qos, resctrl, blkio)."""

    ls_enable: bool = False
    be_enable: bool = False
    ls_group_identity: int = 2    # bvt.warp_ns group for LS
    be_group_identity: int = -1   # bvt for BE
    llc_be_percent: int = 100     # resctrl LLC ways for BE
    mba_be_percent: int = 100     # resctrl memory-bandwidth for BE
    blkio_enable: bool = False    # per-QoS io weights (blkioQOS)
    ls_blkio_weight: int = 500    # io.weight / blkio.bfq.weight for LS tier
    be_blkio_weight: int = 100    # and for BE tier
    core_sched_enable: bool = False  # SMT core-sched cookies per QoS group
    net_qos_policy: str = ""      # "" disabled | "terwayQos" (NETQOSPolicy)
    net_hw_tx_bps: int = 0        # node NIC egress ceiling, bytes/s (0 = none)
    net_hw_rx_bps: int = 0        # node NIC ingress ceiling


@dataclass
class CPUBurstStrategy:
    policy: str = "none"  # none | cpuBurstOnly | cfsQuotaBurstOnly | auto
    cpu_burst_percent: int = 1000
    cfs_quota_burst_percent: int = 300
    cfs_quota_burst_period_seconds: int = -1
    shared_pool_threshold_percent: int = 50


@dataclass
class SystemStrategy:
    min_free_kbytes_factor: int = 100
    watermark_scale_factor: int = 150
    memcg_reap_enabled: bool = False


@dataclass
class NodeSLO:
    """Per-node QoS strategy rendered by the nodeslo controller from the cluster
    sloconfig ConfigMap + node overrides (pkg/slo-controller/nodeslo/)."""

    meta: ObjectMeta = field(default_factory=ObjectMeta)  # name == node name
    resource_used_threshold_with_be: ResourceThresholdStrategy = field(
        default_factory=ResourceThresholdStrategy
    )
    resource_qos_strategy: ResourceQOSStrategy = field(
        default_factory=ResourceQOSStrategy
    )
    cpu_burst_strategy: CPUBurstStrategy = field(default_factory=CPUBurstStrategy)
    system_strategy: SystemStrategy = field(default_factory=SystemStrategy)
    extensions: Dict[str, Any] = field(default_factory=dict)


def host_applications(slo: Optional["NodeSLO"]) -> List[Dict[str, Any]]:
    """Canonical accessor for the NodeSLO `hostApplications` extension
    (apis/slo/v1alpha1/nodeslo_types.go:409 HostApplications): a list of
    {name, cgroupPath, qos} entries describing non-k8s host services.
    Consumers (metricsadvisor collector, qosmanager suppress accounting,
    runtimehooks group identity) each require different fields, so this only
    normalizes the container: non-dict entries are dropped."""
    if slo is None:
        return []
    apps = (slo.extensions or {}).get("hostApplications", [])
    return [a for a in apps if isinstance(a, dict)]


# ---------------------------------------------------------------------------
# NodeResourceTopology CR (reported by koordlet statesinformer nodeTopo plugin)
# ---------------------------------------------------------------------------


@dataclass
class CPUInfo:
    cpu_id: int = 0
    core_id: int = 0
    socket_id: int = 0
    numa_node_id: int = 0


@dataclass
class NUMAZone:
    numa_id: int = 0
    allocatable: ResourceList = field(default_factory=ResourceList)


@dataclass
class NodeResourceTopology:
    meta: ObjectMeta = field(default_factory=ObjectMeta)  # name == node name
    cpus: List[CPUInfo] = field(default_factory=list)
    zones: List[NUMAZone] = field(default_factory=list)
    kubelet_cpu_manager_policy: str = "none"
    # cpus already claimed by kubelet static cpu-manager (cpu ids)
    kubelet_reserved_cpus: List[int] = field(default_factory=list)


# ---------------------------------------------------------------------------
# PodMigrationJob CR (apis/scheduling/v1alpha1/pod_migration_job_types.go)
# ---------------------------------------------------------------------------


@dataclass
class PodMigrationJob:
    meta: ObjectMeta = field(default_factory=ObjectMeta)
    pod_namespace: str = ""
    pod_name: str = ""
    mode: str = "ReservationFirst"  # ReservationFirst | EvictDirectly
    ttl_seconds: int = 300
    # status
    phase: str = "Pending"  # Pending/Running/Succeeded/Failed
    reservation_name: str = ""
    message: str = ""


@dataclass
class PodDisruptionBudget:
    """policy/v1 PDB subset the eviction helpers honor
    (pkg/descheduler/evictions respects PDBs before evicting)."""

    meta: ObjectMeta = field(default_factory=ObjectMeta)
    selector: Dict[str, str] = field(default_factory=dict)  # label selector
    min_available: Optional[int] = None
    max_unavailable: Optional[int] = None

    def matches(self, pod: "Pod") -> bool:
        if pod.meta.namespace != self.meta.namespace:
            return False
        return all(pod.meta.labels.get(k) == v for k, v in self.selector.items())


# ---------------------------------------------------------------------------
# ClusterColocationProfile CR (webhook/pod/mutating/cluster_colocation_profile.go)
# ---------------------------------------------------------------------------


@dataclass
class ClusterColocationProfile:
    meta: ObjectMeta = field(default_factory=ObjectMeta)
    namespace_selector: Dict[str, str] = field(default_factory=dict)
    selector: Dict[str, str] = field(default_factory=dict)
    # percent of matching pods the profile applies to (None == 100;
    # cluster_colocation_profile.go:147-154 "Probability")
    probability: Optional[int] = None
    qos_class: Optional[QoSClass] = None
    priority_class_name: str = ""
    koordinator_priority: Optional[int] = None
    scheduler_name: str = ""
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)


@dataclass
class ConfigMap:
    meta: ObjectMeta = field(default_factory=ObjectMeta)
    data: Dict[str, str] = field(default_factory=dict)


@dataclass
class Namespace:
    """core/v1 Namespace (labels only): the colocation-profile webhook
    matches its namespaceSelector against these labels
    (pod/mutating/cluster_colocation_profile.go:113-130)."""

    meta: ObjectMeta = field(default_factory=ObjectMeta)


# ---------------------------------------------------------------------------
# ElasticQuotaProfile CR (pkg/quota-controller/profile)
# ---------------------------------------------------------------------------


@dataclass
class ElasticQuotaProfile:
    meta: ObjectMeta = field(default_factory=ObjectMeta)
    quota_name: str = ""
    node_selector: Dict[str, str] = field(default_factory=dict)
    quota_labels: Dict[str, str] = field(default_factory=dict)
