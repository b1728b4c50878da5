"""Prometheus-style metrics for the node agent.

Analog of reference `pkg/koordlet/metrics/`: gauges/counters for QoS actions
(BE suppress level, evictions, CPI, PSI) labeled by node/pod, with a text
exposition format so any scraper (or test) can read the agent's state. The
``Registry`` class is the port's one copy in scheduler/metrics.py (the JAX
package defines it here and its scheduler imports it from here); this
module defines the agent's own ``REGISTRY`` and series on it, and keeps
``Registry`` importable from here.
"""

from __future__ import annotations

from koordinator_tpu_torch.scheduler.metrics import Registry

# the agent-wide default registry and its well-known metrics
# (pkg/koordlet/metrics/{common,resource_summary,qos}.go)
REGISTRY = Registry()

BE_SUPPRESS_CPU_CORES = REGISTRY.gauge(
    "koordlet_be_suppress_cpu_cores",
    "CPU cores the BE tier is currently suppressed to")
POD_EVICTION_TOTAL = REGISTRY.counter(
    "koordlet_pod_eviction_total",
    "Pods evicted by qosmanager, labeled by reason")
CONTAINER_CPI = REGISTRY.gauge(
    "koordlet_container_cpi",
    "Cycles per instruction, labeled by pod")
NODE_CPU_PSI_FULL_AVG10 = REGISTRY.gauge(
    "koordlet_node_cpu_psi_full_avg10",
    "Node cpu full-stall pressure, 10s average")
NODE_MEM_PSI_FULL_AVG10 = REGISTRY.gauge(
    "koordlet_node_mem_psi_full_avg10",
    "Node memory full-stall pressure, 10s average")
NODE_RESOURCE_ALLOCATABLE = REGISTRY.gauge(
    "koordlet_node_resource_allocatable",
    "Node allocatable, labeled by resource")
CPU_BURST_TOTAL = REGISTRY.counter(
    "koordlet_cpu_burst_total",
    "cfs burst applications, labeled by pod")
RESCTRL_UPDATE_TOTAL = REGISTRY.counter(
    "koordlet_resctrl_update_total",
    "resctrl schemata updates, labeled by group")
QOS_CYCLE_SECONDS = REGISTRY.histogram(
    "koordlet_qosmanager_cycle_seconds",
    "End-to-end qosmanager strategy-loop latency")
QOS_STRATEGY_RUN_TOTAL = REGISTRY.counter(
    "koordlet_qos_strategy_run_total",
    "QoS strategy executions, labeled by strategy")
INFORMER_ERRORS_TOTAL = REGISTRY.counter(
    "koord_koordlet_informer_errors_total",
    "Errors swallowed inside statesinformer plugins (device probe, "
    "kubelet pulls), labeled by informer and stage — a rising rate "
    "means an informer is silently degraded, not healthy")
