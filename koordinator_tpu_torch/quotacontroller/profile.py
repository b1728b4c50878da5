"""ElasticQuotaProfile controller.

Analog of `pkg/quota-controller/profile/profile_controller.go`: a profile
selects a node group (e.g. an AZ) by labels and generates/refreshes an
ElasticQuota whose min/max track the selected nodes' total allocatable (ratio
annotation supported)."""

from __future__ import annotations

from typing import Optional

from koordinator_tpu_torch.api.objects import (
    ElasticQuota,
    ElasticQuotaProfile,
    LABEL_QUOTA_IS_PARENT,
    ObjectMeta,
)
from koordinator_tpu_torch.api.resources import ResourceList, ResourceName
from koordinator_tpu_torch.client.store import (
    KIND_ELASTIC_QUOTA,
    KIND_NODE,
    KIND_QUOTA_PROFILE,
    ObjectStore,
)

ANNOTATION_QUOTA_RATIO = "quota.scheduling.koordinator.sh/total-resource-ratio"


class QuotaProfileController:
    def __init__(self, store: ObjectStore):
        self.store = store

    def reconcile(self) -> int:
        changes = 0
        for profile in self.store.list(KIND_QUOTA_PROFILE):
            total = ResourceList()
            for node in self.store.list(KIND_NODE):
                if all(
                    node.meta.labels.get(k) == v
                    for k, v in profile.node_selector.items()
                ):
                    total = total.add(node.allocatable)
            ratio = 1.0
            raw = profile.meta.annotations.get(ANNOTATION_QUOTA_RATIO)
            if raw:
                try:
                    ratio = max(0.0, min(1.0, float(raw)))
                except ValueError:
                    ratio = 1.0
            scaled = ResourceList(
                {
                    k: int(v * ratio)
                    for k, v in total.quantities.items()
                    if k in (ResourceName.CPU, ResourceName.MEMORY)
                }
            )
            name = profile.quota_name or profile.meta.name
            key = f"{profile.meta.namespace}/{name}"
            existing: Optional[ElasticQuota] = self.store.get(KIND_ELASTIC_QUOTA, key)
            if existing is None:
                meta = ObjectMeta(
                    name=name,
                    namespace=profile.meta.namespace,
                    labels={LABEL_QUOTA_IS_PARENT: "true", **profile.quota_labels},
                )
                self.store.add(
                    KIND_ELASTIC_QUOTA,
                    ElasticQuota(meta=meta, min=scaled.copy(), max=scaled.copy()),
                )
                changes += 1
            elif existing.min.quantities != scaled.quantities:
                existing.min = scaled.copy()
                existing.max = scaled.copy()
                self.store.update(KIND_ELASTIC_QUOTA, existing)
                changes += 1
        return changes
