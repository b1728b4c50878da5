"""NodeMetric controller: one NodeMetric CR per node + collect policy.

Analog of `pkg/slo-controller/nodemetric/nodemetric_controller.go:59-180`: on
node events, ensure the NodeMetric CR exists and its spec (report interval,
aggregate windows) reflects the cluster sloconfig; delete orphans."""

from __future__ import annotations

from typing import Optional

from koordinator_tpu_torch.api.objects import NodeMetric, ObjectMeta
from koordinator_tpu_torch.client.store import (
    KIND_NODE,
    KIND_NODE_METRIC,
    ObjectStore,
)
from koordinator_tpu_torch.utils.sloconfig import ColocationConfig


class NodeMetricController:
    def __init__(self, store: ObjectStore, config: Optional[ColocationConfig] = None):
        self.store = store
        self.config = config or ColocationConfig()

    def reconcile(self) -> int:
        """Ensure CR per node; returns number of changes."""
        changes = 0
        nodes = {n.meta.name for n in self.store.list(KIND_NODE)}
        existing = {m.meta.name for m in self.store.list(KIND_NODE_METRIC)}
        interval = max(
            60,
            self.config.cluster_strategy.metric_aggregate_duration_seconds // 5,
        )
        for name in nodes - existing:
            self.store.add(
                KIND_NODE_METRIC,
                NodeMetric(
                    meta=ObjectMeta(name=name, namespace=""),
                    report_interval_seconds=interval,
                ),
            )
            changes += 1
        for name in existing - nodes:
            self.store.delete(KIND_NODE_METRIC, f"/{name}")
            changes += 1
        return changes
