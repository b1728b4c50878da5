"""koord-manager metrics registry (analog of reference
pkg/slo-controller + pkg/quota-controller metrics).

The same Registry class as the scheduler's (scheduler/metrics.py). The
port holds only the metric the scheduler side bumps: the elastic-quota
overuse revoke loop runs inside the scheduler cycle
(plugins/elasticquota.py). The rest of the manager's catalog comes with
the manager slice.
"""

from __future__ import annotations

from koordinator_tpu_torch.scheduler.metrics import Registry

REGISTRY = Registry()

QUOTA_REVOKES_TOTAL = REGISTRY.counter(
    "koord_manager_quota_revokes_total",
    "Pods evicted by the elastic-quota overuse revoke loop",
)
