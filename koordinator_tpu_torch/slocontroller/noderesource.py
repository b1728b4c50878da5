"""NodeResource controller: the colocation resource pipeline, vectorized.

Analog of `pkg/slo-controller/noderesource/` (controller :72-165, batchresource
plugin + util.go:38-66, midresource, degrade :467-485). The per-node formula

  System.Used        = max(Node.Used - Pod(All).Used, Node.Anno.Reserved)
  Batch.Alloc[usage] = max(Node.Total*(reclaim%/100) - Node.Reserved
                           - System.Used - Pod(HP).Used, 0)
  Batch.Alloc[request]        likewise with requests and System.Reserved
  Batch.Alloc[maxUsageRequest] likewise with max(request, used)
  Mid.Alloc          = min(ProdReclaimable, Node.Total * mid%/100)

is identical for every node — SURVEY.md 7's "already pure tensor math over
ResourceLists" — so the whole cluster reconciles in ONE [N, R] tensor pass
instead of the reference's per-node reconcile loop. Stale NodeMetrics degrade
the node (batch resources reset to zero) per the degrade window.

The pass (``_batch_mid_kernel``) is float32 torch ops. On CPU tensors it is
the host oracle; the device colo pass (colo/step.py) calls the same function
on the card's tensors, so both engines run one f32 op sequence and the
``int()`` writeback lands on the same integers.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from koordinator_tpu_torch.api.objects import Node, NodeMetric, Pod
from koordinator_tpu_torch.api.priority import PriorityClass
from koordinator_tpu_torch.api.resources import (
    NUM_RESOURCES,
    RESOURCE_INDEX,
    ResourceList,
    ResourceName,
)
from koordinator_tpu_torch.client.store import (
    KIND_NODE,
    KIND_NODE_METRIC,
    KIND_POD,
    ObjectStore,
)
from koordinator_tpu_torch.slocontroller.noderesource_plugins import (
    CPU_NORMALIZATION_CONFIG_KEY,
    run_plugin_chain,
)
from koordinator_tpu_torch.utils.sloconfig import (
    POLICY_MAX_USAGE_REQUEST,
    POLICY_REQUEST,
    ColocationConfig,
    ColocationConfigSource,
)

CPU = RESOURCE_INDEX[ResourceName.CPU]
MEM = RESOURCE_INDEX[ResourceName.MEMORY]
ANNOTATION_NODE_RESERVATION = "node.koordinator.sh/reservation"


def node_static_row(node: Node, strategy):
    """The metric-independent packed columns for one node: capacity, the
    node-reservation annotation split, and the per-node strategy scalars.
    Shared by the host gather AND the colo pack (colo/pack.py) so the
    device pass reads bit-identical rows."""
    R = NUM_RESOURCES
    capacity = (node.capacity.to_vector() if node.capacity
                else node.allocatable.to_vector())
    node_reserved = np.zeros(R, np.float32)
    system_reserved = np.zeros(R, np.float32)
    reclaim = np.zeros(R, np.float32)
    mid_pct = np.zeros(R, np.float32)
    reclaim[CPU] = strategy.cpu_reclaim_threshold_percent
    reclaim[MEM] = strategy.memory_reclaim_threshold_percent
    mid_pct[CPU] = strategy.mid_cpu_threshold_percent
    mid_pct[MEM] = strategy.mid_memory_threshold_percent
    raw = node.meta.annotations.get(ANNOTATION_NODE_RESERVATION)
    if raw:
        import json

        try:
            data = json.loads(raw)
            from koordinator_tpu_torch.api.resources import parse_quantity

            def to_vec(section):
                return ResourceList(
                    {
                        k: parse_quantity(v, cpu=(k == ResourceName.CPU))
                        for k, v in section.items()
                    }
                ).to_vector()

            node_reserved = to_vec(data.get("resources", {}))
            # the system daemons' reserve feeds both the system-used
            # floor and the by-request policy subtrahend
            system_reserved = to_vec(data.get("systemResources", {}))
        except (ValueError, TypeError):
            pass
    degrade_seconds = strategy.degrade_time_minutes * 60.0
    return capacity, node_reserved, system_reserved, reclaim, mid_pct, \
        degrade_seconds


def node_metric_row(nm: Optional[NodeMetric], pods: List[Pod]):
    """The metric-dependent packed columns for one node: usage, prod
    reclaimable, and the per-class pod aggregate sums — accumulated in
    float64 over the exact f32 per-pod rows (order-free, the
    SnapshotCache discipline), cast to f32 at the end. ``pods`` is the
    node's assigned non-terminated set; a missing/zeroed NodeMetric
    yields all-zero rows (the kernel's degrade gate zeroes the outputs
    for such nodes anyway)."""
    R = NUM_RESOURCES
    node_used = np.zeros(R, np.float32)
    prod_reclaimable = np.zeros(R, np.float32)
    pod_all_used = np.zeros(R, np.float64)
    hp_used = np.zeros(R, np.float64)
    hp_request = np.zeros(R, np.float64)
    hp_max = np.zeros(R, np.float64)
    if nm is None or nm.update_time <= 0:
        return (node_used, prod_reclaimable,
                pod_all_used.astype(np.float32),
                hp_used.astype(np.float32),
                hp_request.astype(np.float32),
                hp_max.astype(np.float32))
    node_used = nm.node_metric.node_usage.to_vector()
    prod_reclaimable = nm.prod_reclaimable.to_vector()
    pod_usage = {
        f"{pm.namespace}/{pm.name}": pm.pod_usage.to_vector()
        for pm in nm.pods_metric
    }
    for pod in pods:
        used = pod_usage.get(pod.meta.key)
        if used is not None:
            pod_all_used += used
        cls = pod.priority_class
        if cls in (PriorityClass.PROD, PriorityClass.MID,
                   PriorityClass.NONE):
            req = pod.spec.requests.to_vector()
            u = used if used is not None else np.zeros(R, np.float32)
            hp_used += u
            hp_request += req
            hp_max += np.maximum(req, u)
    return (node_used, prod_reclaimable,
            pod_all_used.astype(np.float32), hp_used.astype(np.float32),
            hp_request.astype(np.float32), hp_max.astype(np.float32))


def _batch_mid_kernel(
    capacity,            # [N, R]
    node_reserved,       # [N, R]
    system_reserved,     # [N, R]
    node_used,           # [N, R]
    pod_all_used,        # [N, R]
    pod_hp_used,         # [N, R]
    pod_hp_request,      # [N, R]
    pod_hp_max_used_req,  # [N, R]
    prod_reclaimable,    # [N, R]
    reclaim_percent,     # [N, R] (cpu/mem thresholds broadcast per axis)
    mid_percent,         # [N, R]
    degraded,            # [N] bool
    cpu_policy: str,
    memory_policy: str,
):
    """The batch/mid formula over float32 tensors on any device: returns
    (batch [N, R], mid [N, R]). The percentages divide by a 0-d tensor on
    the inputs' device, never by a Python number: on CUDA, torch turns a
    division by a host scalar into a multiplication by its reciprocal,
    which can differ from the true quotient in the last bit."""
    import torch

    hundred = capacity.new_tensor(100.0)
    reclaimable_capacity = capacity * reclaim_percent / hundred
    system_used = torch.clamp_min(node_used - pod_all_used, 0.0)
    system_used = torch.maximum(system_used, system_reserved)
    by_usage = torch.clamp_min(
        reclaimable_capacity - node_reserved - system_used - pod_hp_used, 0.0
    )
    by_request = torch.clamp_min(
        reclaimable_capacity - node_reserved - system_reserved - pod_hp_request, 0.0
    )
    by_max = torch.clamp_min(
        reclaimable_capacity - node_reserved - system_used - pod_hp_max_used_req, 0.0
    )

    def pick(policy):
        if policy == POLICY_REQUEST:
            return by_request
        if policy == POLICY_MAX_USAGE_REQUEST:
            return by_max
        return by_usage

    # the policy pick is a column copy chosen here, on the host, by the
    # policy strings
    batch = by_usage.clone()
    batch[:, CPU] = pick(cpu_policy)[:, CPU]
    batch[:, MEM] = pick(memory_policy)[:, MEM]
    batch = torch.where(degraded[:, None], 0.0, batch)
    mid = torch.minimum(prod_reclaimable, capacity * mid_percent / hundred)
    mid = torch.where(degraded[:, None], 0.0, torch.clamp_min(mid, 0.0))
    return batch, mid


class NodeResourceController:
    """The host oracle of the colocation resource pipeline. With
    koordcolo (colo/) attached, the SAME formula runs as part of the
    device colo pass and this controller is retained as the
    decision-parity reference (``run_colo_parity``); ``apply`` is the
    shared writeback both engines route through. The effective config
    hot-reloads from the slo-controller-config ConfigMap (memoized on
    its resourceVersion) with the constructor config as the base."""

    def __init__(self, store: ObjectStore, config: Optional[ColocationConfig] = None):
        self.store = store
        self.config_source = ColocationConfigSource(store, config)

    @property
    def config(self) -> ColocationConfig:
        return self.config_source.get()

    # -- host gather ---------------------------------------------------------
    def _gather(self, nodes: List[Node], now: float):
        config = self.config
        N = len(nodes)
        R = NUM_RESOURCES
        capacity = np.zeros((N, R), np.float32)
        node_reserved = np.zeros((N, R), np.float32)
        system_reserved = np.zeros((N, R), np.float32)
        node_used = np.zeros((N, R), np.float32)
        pod_all_used = np.zeros((N, R), np.float32)
        pod_hp_used = np.zeros((N, R), np.float32)
        pod_hp_request = np.zeros((N, R), np.float32)
        pod_hp_max = np.zeros((N, R), np.float32)
        prod_reclaimable = np.zeros((N, R), np.float32)
        reclaim = np.zeros((N, R), np.float32)
        mid_pct = np.zeros((N, R), np.float32)
        degraded = np.zeros(N, bool)

        pods_by_node: Dict[str, List[Pod]] = {}
        for pod in self.store.list(KIND_POD):
            if pod.is_assigned and not pod.is_terminated:
                pods_by_node.setdefault(pod.spec.node_name, []).append(pod)

        for i, node in enumerate(nodes):
            strategy = config.strategy_for_node(
                node.meta.labels, node.meta.annotations)
            (capacity[i], node_reserved[i], system_reserved[i],
             reclaim[i], mid_pct[i], degrade_seconds) = node_static_row(
                node, strategy)
            nm: Optional[NodeMetric] = self.store.get(
                KIND_NODE_METRIC, f"/{node.meta.name}"
            )
            if nm is None or nm.update_time <= 0:
                degraded[i] = True
                continue
            if now - nm.update_time > degrade_seconds:
                degraded[i] = True  # degrade on stale metrics (plugin.go:467-485)
                continue
            (node_used[i], prod_reclaimable[i], pod_all_used[i],
             pod_hp_used[i], pod_hp_request[i], pod_hp_max[i]) = (
                node_metric_row(nm, pods_by_node.get(node.meta.name, [])))
        return (capacity, node_reserved, system_reserved, node_used, pod_all_used,
                pod_hp_used, pod_hp_request, pod_hp_max, prod_reclaimable,
                reclaim, mid_pct, degraded)

    # -- reconcile -----------------------------------------------------------
    def reconcile(self, now: Optional[float] = None) -> int:
        now = time.time() if now is None else now
        nodes = self.store.list(KIND_NODE)
        if not nodes:
            return 0
        arrays = self._gather(nodes, now)
        strategy = self.config.cluster_strategy
        import torch

        batch, mid = _batch_mid_kernel(
            *[torch.from_numpy(a) for a in arrays],
            cpu_policy=strategy.cpu_calculate_policy,
            memory_policy=strategy.memory_calculate_policy,
        )
        batch, mid = batch.numpy(), mid.numpy()
        return self.apply(nodes, batch[:, CPU], batch[:, MEM],
                          mid[:, CPU], mid[:, MEM])

    # -- writeback (shared with the device colo pass) -------------------------
    def apply(self, nodes: List[Node], batch_cpu, batch_mem,
              mid_cpu, mid_mem) -> int:
        """Publish the computed batch/mid columns onto node status and
        run the post-pass plugin chain — the single writeback both the
        host reconcile and the colo device pass route through, so the
        store-visible effect of a pass is engine-independent by
        construction."""
        changes = 0
        for i, node in enumerate(nodes):
            update = ResourceList.of(
                batch_cpu=int(batch_cpu[i]),
                batch_memory=int(batch_mem[i]) * 1024 * 1024,
                mid_cpu=int(mid_cpu[i]),
                mid_memory=int(mid_mem[i]) * 1024 * 1024,
            )
            merged = dict(node.allocatable.quantities)
            changed = False
            for name in (
                ResourceName.BATCH_CPU,
                ResourceName.BATCH_MEMORY,
                ResourceName.MID_CPU,
                ResourceName.MID_MEMORY,
            ):
                val = update[name]
                if merged.get(name, 0) != val:
                    merged[name] = val
                    changed = True
            if changed:
                node.allocatable = ResourceList(merged)
            # post-pass plugin chain: cpunormalization + gpudeviceresource +
            # resourceamplification (reference plugins_profile.go order);
            # runs after the batch/mid merge so it sees the final allocatable
            plugin_changed = run_plugin_chain(
                node, self.store,
                cpu_normalization_config=self._cpu_normalization_config())
            if changed or plugin_changed:
                self.store.update(KIND_NODE, node)
                changes += 1
        return changes

    def _cpu_normalization_config(self) -> Optional[dict]:
        """cpu-normalization-config section of the slo-controller-config
        ConfigMap (configuration/slo_controller_config.go:34)."""
        from koordinator_tpu_torch.client.store import KIND_CONFIG_MAP
        from koordinator_tpu_torch.utils.sloconfig import CONFIG_MAP_NAME

        cm = self.store.get(
            KIND_CONFIG_MAP, f"koordinator-system/{CONFIG_MAP_NAME}")
        raw = getattr(cm, "data", {}).get(CPU_NORMALIZATION_CONFIG_KEY) if cm else None
        if not raw:
            return None
        import json

        try:
            cfg = json.loads(raw)
        except ValueError:
            return None
        return cfg if isinstance(cfg, dict) else None
