"""Admission webhook framework + handlers.

Analog of reference `pkg/webhook/` (server.go + per-GVK registration):
  * pod mutating: ClusterColocationProfile application — inject QoS label,
    priority class/value, scheduler name, labels/annotations, and translate
    requests to batch-*/mid-* extended resources
    (pod/mutating/cluster_colocation_profile.go:53-259 + :157-259); the
    original requests are recorded in the extended-resource-spec annotation for
    koordlet/runtime-proxy (mutating/extended_resource_spec.go).
  * pod validating: QoS/priority combination rules + resource consistency
    (pod/validating/).
  * elasticquota mutating/validating: tree guard rails (webhook/elasticquota/):
    parent existence, min <= max, parent-child min consistency, forbidden
    modifications.
  * node validating: resource amplification annotations (webhook/node/).
  * configmap validating: sloconfig schema (webhook/cm/ via utils/sloconfig).

Wired into the store as admission interceptors: `admit(kind, obj)` runs
mutators then validators; store helpers in tests call it before add/update
(the reference's apiserver does the same).
"""

from __future__ import annotations

import json
import math
from typing import Callable, Dict, List, Optional

from koordinator_tpu_torch.api.objects import (
    ANNOTATION_EXTENDED_RESOURCE_SPEC,
    ANNOTATION_RESERVE_POD,
    ClusterColocationProfile,
    ConfigMap,
    ElasticQuota,
    LABEL_POD_PRIORITY,
    LABEL_POD_QOS,
    Node,
    Pod,
)
from koordinator_tpu_torch.api.priority import (
    DEFAULT_PRIORITY_BY_CLASS,
    PriorityClass,
    priority_class_by_name,
)
from koordinator_tpu_torch.api.qos import QoSClass
from koordinator_tpu_torch.api.resources import (
    ResourceList,
    ResourceName,
    translate_resource_by_priority_class,
)
from koordinator_tpu_torch.client.store import (
    KIND_COLOCATION_PROFILE,
    KIND_ELASTIC_QUOTA,
    KIND_QUOTA_PROFILE,
    ObjectStore,
)
from koordinator_tpu_torch.utils.features import MANAGER_GATES
from koordinator_tpu_torch.utils.sloconfig import (
    COLOCATION_CONFIG_KEY,
    CONFIG_MAP_NAME,
    parse_colocation_config,
)


class AdmissionError(Exception):
    """Admission denied (apiserver 4xx analog)."""


# injectable randomness for profile probability (the reference stubs
# rand.Intn in tests the same way: cluster_colocation_profile.go:47)
_rand_intn: Callable[[int], int] = None


def _default_rand_intn(n: int) -> int:
    import random

    return random.randrange(n)


# annotations only the scheduler may set; user pods are rejected
# (pod/validating/verify_annotations.go:60-76)
FORBIDDEN_POD_ANNOTATIONS = (ANNOTATION_RESERVE_POD,)


class AdmissionServer:
    def __init__(self, store: ObjectStore):
        self.store = store

    # ------------------------------------------------------------------
    def admit_pod_create(self, pod: Pod) -> Pod:
        if MANAGER_GATES.enabled("PodMutatingWebhook"):
            self.mutate_pod(pod)
        if MANAGER_GATES.enabled("PodValidatingWebhook"):
            self.validate_pod(pod)
        return pod

    # -- pod mutating ---------------------------------------------------
    def _namespace_matches(self, namespace: str,
                           selector: Dict[str, str]) -> bool:
        """namespaceSelector matches the Namespace object's labels
        (cluster_colocation_profile.go:113-130); a missing Namespace object
        cannot match a non-empty selector."""
        from koordinator_tpu_torch.client.store import KIND_NAMESPACE

        ns = self.store.get(KIND_NAMESPACE, f"/{namespace}")
        if ns is None:
            return False
        return all(ns.meta.labels.get(k) == v for k, v in selector.items())

    def _probability_skips(self, profile: ClusterColocationProfile) -> bool:
        """Percent-based sampling (cluster_colocation_profile.go:147-154):
        skip when percent == 0, apply when 100, else draw. The strict `>`
        mirrors the reference exactly — including its bias of applying on
        draws 0..percent, i.e. (percent+1)% of pods for 0 < percent < 100."""
        percent = profile.probability
        if percent is None:
            return False
        rand_intn = _rand_intn or _default_rand_intn
        return percent == 0 or (percent != 100 and rand_intn(100) > percent)

    def _matching_profile(self, pod: Pod) -> Optional[ClusterColocationProfile]:
        for profile in sorted(
            self.store.list(KIND_COLOCATION_PROFILE), key=lambda p: p.meta.name
        ):
            if profile.namespace_selector and not self._namespace_matches(
                pod.meta.namespace, profile.namespace_selector
            ):
                continue
            if profile.selector and not all(
                pod.meta.labels.get(k) == v for k, v in profile.selector.items()
            ):
                continue
            if self._probability_skips(profile):
                continue
            return profile
        return None

    def mutate_pod_quota_tree_affinity(self, pod: Pod) -> None:
        """multi_quota_tree_affinity.go:37-110: a pod whose quota belongs to a
        tree gets the tree profile's node selector injected so it can only
        land on that tree's nodes."""
        if not MANAGER_GATES.enabled("MultiQuotaTree"):
            return
        quota_name = pod.quota_name or pod.meta.namespace
        quota = None
        for q in self.store.list(KIND_ELASTIC_QUOTA):
            if q.meta.name == quota_name:
                quota = q
                break
        if quota is None or not quota.tree_id:
            return
        from koordinator_tpu_torch.api.objects import LABEL_QUOTA_TREE_ID

        for profile in sorted(self.store.list(KIND_QUOTA_PROFILE),
                              key=lambda p: p.meta.name):
            if profile.quota_labels.get(LABEL_QUOTA_TREE_ID) != quota.tree_id:
                continue
            if profile.node_selector:  # first profile WITH a selector wins
                for k, v in profile.node_selector.items():
                    pod.spec.node_selector.setdefault(k, v)
                return

    def mutate_pod(self, pod: Pod) -> None:
        """cluster_colocation_profile.go:53-259. (Tree affinity runs AFTER the
        profile so a profile-injected quota-name label is honored.)"""
        profile = self._matching_profile(pod)
        if profile is not None:
            pod.meta.labels.update(profile.labels)
            pod.meta.annotations.update(profile.annotations)
            if profile.qos_class is not None:
                pod.meta.labels[LABEL_POD_QOS] = profile.qos_class.label
            if profile.scheduler_name:
                pod.spec.scheduler_name = profile.scheduler_name
            if profile.priority_class_name:
                pod.spec.priority_class_name = profile.priority_class_name
                cls = priority_class_by_name(profile.priority_class_name)
                if cls is not PriorityClass.NONE and pod.spec.priority is None:
                    pod.spec.priority = DEFAULT_PRIORITY_BY_CLASS[cls]
            if profile.koordinator_priority is not None:
                pod.meta.labels[LABEL_POD_PRIORITY] = str(profile.koordinator_priority)
        self.mutate_pod_quota_tree_affinity(pod)
        self.mutate_extended_resources(pod)

    def mutate_extended_resources(self, pod: Pod) -> None:
        """requests cpu/memory -> batch-*/mid-* for BATCH/MID pods
        (:157-259), recording the original spec in the annotation."""
        if MANAGER_GATES.enabled("ColocationProfileSkipMutatingResources"):
            return
        cls = pod.priority_class
        if cls not in (PriorityClass.BATCH, PriorityClass.MID):
            return
        original: Dict[str, Dict[str, int]] = {}
        for source in (pod.spec.requests, pod.spec.limits):
            moved = {}
            for name in (ResourceName.CPU, ResourceName.MEMORY):
                val = source[name]
                if not val:
                    continue
                target = translate_resource_by_priority_class(cls, name)
                moved[name] = (target, val)
            for name, (target, val) in moved.items():
                del source.quantities[name]
                source.quantities[target] = val
            if moved and source is pod.spec.requests:
                original["requests"] = {t: v for (t, v) in moved.values()}
        if original:
            pod.meta.annotations[ANNOTATION_EXTENDED_RESOURCE_SPEC] = json.dumps(
                {"containers": {"main": original}}
            )

    # -- pod validating -------------------------------------------------
    def validate_pod(self, pod: Pod) -> None:
        """pod/validating: QoS x priority-class consistency rules +
        forbidden scheduler-internal annotations."""
        for ann in FORBIDDEN_POD_ANNOTATIONS:
            if ann in pod.meta.annotations:
                raise AdmissionError(f"annotation {ann!r} cannot be set")
        qos = pod.qos_class
        cls = pod.priority_class
        if qos is QoSClass.BE and cls == PriorityClass.PROD:
            raise AdmissionError("BE pods cannot use koord-prod priority")
        if qos in (QoSClass.LSE, QoSClass.LSR):
            if cls in (PriorityClass.BATCH, PriorityClass.FREE):
                raise AdmissionError(
                    f"{qos.label} pods cannot use {cls.label} priority"
                )
            cpu = pod.spec.requests[ResourceName.CPU]
            if cpu % 1000 != 0:
                raise AdmissionError(
                    f"{qos.label} pods must request whole cpus, got {cpu}m"
                )
        be_resources = pod.spec.requests[ResourceName.BATCH_CPU] or pod.spec.requests[
            ResourceName.BATCH_MEMORY
        ]
        if be_resources and cls not in (PriorityClass.BATCH, PriorityClass.FREE, PriorityClass.NONE):
            raise AdmissionError("batch resources require koord-batch/free priority")
        # resource verify (pod/validating resource checks): limits bound requests
        for name, req in pod.spec.requests.quantities.items():
            limit = pod.spec.limits.get(name, 0)
            if limit and req > limit:
                raise AdmissionError(
                    f"request[{name}]={req} exceeds limit={limit}")

    # -- elasticquota ---------------------------------------------------
    def _quota_by_name(self, name: str) -> Optional[ElasticQuota]:
        for q in self.store.list(KIND_ELASTIC_QUOTA):
            if q.meta.name == name:
                return q
        return None

    def _quota_children(self, name: str) -> List[ElasticQuota]:
        return [q for q in self.store.list(KIND_ELASTIC_QUOTA)
                if q.parent == name and q.meta.name != name]

    def validate_elastic_quota(self, quota: ElasticQuota,
                               old: Optional[ElasticQuota] = None) -> None:
        """webhook/elasticquota guard rails (quota_topology_check.go)."""
        for name, mn in quota.min.quantities.items():
            mx = quota.max.get(name, 0)
            if mx and mn > mx:
                raise AdmissionError(f"min[{name}]={mn} exceeds max={mx}")
        parent_name = quota.parent
        if parent_name:
            parent = self._quota_by_name(parent_name)
            if parent is None:
                raise AdmissionError(f"parent quota {parent_name!r} does not exist")
            if not parent.is_parent:
                raise AdmissionError(f"quota {parent_name!r} is not a parent group")
            # checkSubAndParentGroupMaxQuotaKeySame (:182-213): a child may
            # only cap resources its parent also caps, else the child's max
            # is unenforceable against the parent's tree accounting
            if parent.max.quantities:
                extra = set(quota.max.quantities) - set(parent.max.quantities)
                if extra:
                    raise AdmissionError(
                        f"max keys {sorted(extra)} not present in parent "
                        f"{parent_name!r} max")
            # checkMinQuotaValidate (:214-255): Σ sibling min (incl. this
            # quota) must fit inside the parent's min — over the UNION of
            # the siblings' min keys, a key the parent's min omits counts
            # as 0 (LessThanOrEqualCompletely semantics), so any child min
            # in it is rejected
            siblings = [q for q in self._quota_children(parent_name)
                        if q.meta.name != quota.meta.name]
            sibling_keys = set(quota.min.quantities).union(
                *[set(q.min.quantities) for q in siblings]) if siblings \
                else set(quota.min.quantities)
            for name in sibling_keys:
                pmn = parent.min.get(name, 0)
                sibling_sum = quota.min.get(name, 0) + sum(
                    q.min.get(name, 0) for q in siblings)
                if sibling_sum > pmn:
                    raise AdmissionError(
                        f"sibling min[{name}] sum={sibling_sum} exceeds "
                        f"parent min={pmn}")
        # Σ children min must fit inside this quota's (possibly shrunken) min
        children = self._quota_children(quota.meta.name)
        for name in {n for c in children for n in c.min.quantities}:
            child_sum = sum(c.min.get(name, 0) for c in children)
            if child_sum > quota.min.get(name, 0):
                raise AdmissionError(
                    f"children min[{name}] sum={child_sum} exceeds new "
                    f"min={quota.min.get(name, 0)}")
        if old is not None:
            self._validate_quota_update(quota, old)

    def _validate_quota_update(self, quota: ElasticQuota,
                               old: ElasticQuota) -> None:
        """checkIsParentChange (:142-165) + tree-id immutability."""
        if MANAGER_GATES.enabled("ElasticQuotaImmutableAnnotations"):
            if old.tree_id and quota.tree_id != old.tree_id:
                raise AdmissionError("quota tree-id is immutable")
        if old.is_parent != quota.is_parent:
            if old.is_parent and self._quota_children(old.meta.name):
                raise AdmissionError(
                    "quota has children; isParent cannot become false")
            from koordinator_tpu_torch.client.store import KIND_POD

            # a pod binds to the quota either by explicit label or by the
            # namespace-default rule (see mutate_pod_quota_tree_affinity);
            # terminated pods no longer hold quota and must not block
            if quota.is_parent and any(
                (p.quota_name or p.meta.namespace) == old.meta.name
                and not p.is_terminated
                for p in self.store.list(KIND_POD)
            ):
                raise AdmissionError(
                    "quota has bound pods; isParent cannot become true")

    def validate_elastic_quota_delete(self, quota: ElasticQuota) -> None:
        """Deletion guard (webhook/elasticquota): a parent group with child
        quotas cannot be deleted (the orphans would silently detach from the
        tree and escape their ancestors' limits)."""
        if not quota.is_parent:
            return
        children = [
            q.meta.name
            for q in self.store.list(KIND_ELASTIC_QUOTA)
            if q.parent == quota.meta.name and q.meta.name != quota.meta.name
        ]
        if children:
            raise AdmissionError(
                f"quota {quota.meta.name!r} still has children: "
                f"{sorted(children)}")

    # -- generic dispatch ----------------------------------------------
    def admit(self, kind: str, obj, old=None, delete: bool = False):
        """Run the registered mutators + validators for a kind (server.go's
        per-GVK handler registration, flattened)."""
        from koordinator_tpu_torch.client.store import (
            KIND_CONFIG_MAP,
            KIND_NODE,
            KIND_POD,
        )

        if kind == KIND_POD and not delete:
            return self.admit_pod_create(obj)
        if kind == KIND_ELASTIC_QUOTA:
            if delete:
                if MANAGER_GATES.enabled("ElasticQuotaValidatingWebhook"):
                    self.validate_elastic_quota_delete(obj)
            elif MANAGER_GATES.enabled("ElasticQuotaValidatingWebhook"):
                self.validate_elastic_quota(obj, old)
        elif kind == KIND_NODE and not delete:
            if MANAGER_GATES.enabled("NodeMutatingWebhook"):
                self.mutate_node(obj, old)
            if MANAGER_GATES.enabled("NodeValidatingWebhook"):
                self.validate_node(obj)
        elif kind == KIND_CONFIG_MAP and not delete:
            if MANAGER_GATES.enabled("ConfigMapValidatingWebhook"):
                self.validate_config_map(obj)
        return obj

    # -- node -----------------------------------------------------------
    AMPLIFICATION_RATIO_ANNOTATION = (
        "node.koordinator.sh/resource-amplification-ratio")
    RAW_ALLOCATABLE_ANNOTATION = "node.koordinator.sh/raw-allocatable"
    _AMPLIFIABLE = (ResourceName.CPU, ResourceName.MEMORY)

    def mutate_node(self, node: Node, old: Optional[Node] = None) -> None:
        """Resource amplification (webhook/node/plugins/resourceamplification):
        allocatable = kubelet-reported raw allocatable x per-resource ratio.
        The raw values are remembered in an annotation so repeated admissions
        don't compound the ratio; a kubelet allocatable change refreshes them.
        Clearing the ratio annotation restores raw allocatable."""
        ann = node.meta.annotations
        raw_ratio = ann.get(self.AMPLIFICATION_RATIO_ANNOTATION, "")
        if not raw_ratio:
            saved = ann.pop(self.RAW_ALLOCATABLE_ANNOTATION, None)
            if saved:  # feature switched off: restore kubelet values
                for name, val in json.loads(saved).items():
                    node.allocatable.quantities[name] = int(val)
            return
        try:
            ratios = json.loads(raw_ratio)
        except ValueError:
            raise AdmissionError("resource-amplification-ratio is not JSON")
        if not isinstance(ratios, dict):
            raise AdmissionError(
                "resource-amplification-ratio must be a JSON object of "
                "resource name to ratio")
        # old-vs-new compares whatever the cluster stored (amplified) against
        # the incoming values; a kubelet raw update that happens to equal the
        # old amplified value is missed — the reference has the identical
        # documented limitation (resource_amplification.go "FIXME 1")
        supported_changed = old is not None and any(
            old.allocatable.get(r) != node.allocatable.get(r)
            for r in self._AMPLIFIABLE
        )
        if self.RAW_ALLOCATABLE_ANNOTATION not in ann or supported_changed:
            raw = {r: node.allocatable.get(r)
                   for r in self._AMPLIFIABLE if node.allocatable.get(r)}
            ann[self.RAW_ALLOCATABLE_ANNOTATION] = json.dumps(raw)
        original = json.loads(ann[self.RAW_ALLOCATABLE_ANNOTATION])
        for name in self._AMPLIFIABLE:
            ratio = ratios.get(name)
            if ratio is None:
                continue
            try:
                ratio = float(ratio)
            except (TypeError, ValueError):
                raise AdmissionError(
                    f"resource-amplification-ratio[{name}] is not a number")
            if not math.isfinite(ratio):
                raise AdmissionError(
                    f"resource-amplification-ratio[{name}] is not finite")
            if ratio <= 1 or name not in original:
                continue
            node.allocatable.quantities[name] = int(original[name] * ratio)

    def validate_node(self, node: Node) -> None:
        raw = node.meta.annotations.get("node.koordinator.sh/cpu-normalization-ratio")
        if raw:
            try:
                ratio = float(raw)
            except ValueError:
                raise AdmissionError("cpu-normalization-ratio must be a number")
            if not 0.1 <= ratio <= 10:
                raise AdmissionError("cpu-normalization-ratio out of range [0.1, 10]")

    # -- configmap ------------------------------------------------------
    def validate_config_map(self, cm: ConfigMap) -> None:
        if cm.meta.name != CONFIG_MAP_NAME:
            return
        if COLOCATION_CONFIG_KEY in cm.data:
            _, err = parse_colocation_config(cm.data)
            if err:
                raise AdmissionError(err)
