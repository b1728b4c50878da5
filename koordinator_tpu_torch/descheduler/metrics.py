"""Descheduler metrics registry (analog of reference pkg/descheduler/metrics/).

The scheduler's Registry class (scheduler/metrics.py), as the manager's
registry uses it, so every binary exposes the same Prometheus text
format and one scrape config covers the deployment."""

from __future__ import annotations

from koordinator_tpu_torch.scheduler.metrics import Registry

REGISTRY = Registry()

CYCLE_SECONDS = REGISTRY.histogram(
    "koord_descheduler_cycle_seconds",
    "End-to-end descheduling round latency (profiles + migration)",
)
MIGRATION_JOBS_CREATED_TOTAL = REGISTRY.counter(
    "koord_descheduler_migration_jobs_created_total",
    "PodMigrationJob CRs created by profile plugins",
)
MIGRATION_TRANSITIONS_TOTAL = REGISTRY.counter(
    "koord_descheduler_migration_transitions_total",
    "PodMigrationJob state transitions executed by the controller",
)
PODS_EVICTED_TOTAL = REGISTRY.counter(
    "koord_descheduler_pods_evicted_total",
    "Pods evicted by descheduling, labeled by profile",
)
# koordbalance (balance/): the device-resident rebalance pass
REBALANCE_CANDIDATES = REGISTRY.counter(
    "koord_descheduler_rebalance_candidates_total",
    "Movable pods on overloaded nodes considered by rebalance passes",
)
REBALANCE_VICTIMS = REGISTRY.counter(
    "koord_descheduler_rebalance_victims_total",
    "Victims selected by rebalance passes (migration-job candidates)",
)
REBALANCE_PASS_SECONDS = REGISTRY.histogram(
    "koord_descheduler_rebalance_pass_seconds",
    "Rebalance victim-selection pass latency (device or host engine)",
)

# koordwatch (obs/timeline.py): a STANDALONE descheduler's private
# device timeline records into this registry so its own /metrics shows
# the windows; a co-located descheduler shares the scheduler's timeline
# (and that registry's series) instead
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
