"""koord-manager metrics registry (analog of reference
pkg/slo-controller + pkg/quota-controller metrics).

The same Registry class as the scheduler's (scheduler/metrics.py), and
the JAX package's catalog: the reconcile metrics the Manager bumps, the
colo pass's (colo/reconciler.py ``_record``), the elastic-quota overuse
revoke count (the revoke loop runs inside the scheduler cycle,
plugins/elasticquota.py), and a standalone manager's device timeline."""

from __future__ import annotations

from koordinator_tpu_torch.scheduler.metrics import Registry

REGISTRY = Registry()

RECONCILE_SECONDS = REGISTRY.histogram(
    "koord_manager_reconcile_seconds",
    "Per-controller reconcile latency, labeled by controller",
)
RECONCILES_TOTAL = REGISTRY.counter(
    "koord_manager_reconciles_total",
    "Reconcile rounds executed per controller (leader only)",
)
# koordcolo (colo/): the device-resident control-plane resource model
COLO_PASS_SECONDS = REGISTRY.histogram(
    "koord_manager_colo_pass_seconds",
    "Colo pass latency (device or host engine), end to end",
)
COLO_PASSES_TOTAL = REGISTRY.counter(
    "koord_manager_colo_passes_total",
    "Colo passes executed, labeled by engine (device/host)",
)
COLO_DEGRADED_NODES = REGISTRY.gauge(
    "koord_manager_colo_degraded_nodes",
    "Nodes whose batch/mid resources were zeroed by the staleness "
    "degrade in the last colo pass",
)
COLO_NODES_CHANGED_TOTAL = REGISTRY.counter(
    "koord_manager_colo_nodes_changed_total",
    "Node status writes the colo writeback committed",
)
COLO_REVOKE_CANDIDATES = REGISTRY.gauge(
    "koord_manager_colo_revoke_candidates",
    "Quota groups over their runtime in the last colo pass "
    "(the revoke-candidate mask population)",
)
QUOTA_REVOKES_TOTAL = REGISTRY.counter(
    "koord_manager_quota_revokes_total",
    "Pods evicted by the elastic-quota overuse revoke loop",
)

# koordwatch (obs/timeline.py): a STANDALONE manager's private colo
# device timeline records into this registry so its own /metrics shows
# the windows; a co-located manager shares the scheduler's timeline
DEVICE_WINDOW_SECONDS = REGISTRY.histogram(
    "koord_device_window_seconds",
    "Device-window dispatch-to-last-sync interval, labeled by consumer "
    "and path",
    buckets=(0.001, 0.005, 0.02, 0.1, 0.5, 2.0, 10.0),
)
DEVICE_IDLE_FRACTION = REGISTRY.gauge(
    "koord_device_idle_fraction",
    "Gap time between consecutive device windows over wall time",
)
