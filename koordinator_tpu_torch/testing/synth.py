"""Synthetic cluster/workload generator.

Produces pods/nodes/NodeMetrics exercising every LoadAware branch: prod/batch/mid
priority bands, BE/LS QoS, DaemonSet pods, zero-request pods (estimator defaults),
limits>requests (100% scaling), expired and missing NodeMetrics, aggregated
percentile usage, custom per-node threshold annotations, and pod metrics for the
assign-cache adjustment paths. Deterministic via seed. Stands in for the
reference's `examples/spark-jobs` trace in benchmarks (BASELINE.md configs).
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from koordinator_tpu_torch.api.objects import (
    LABEL_POD_QOS,
    Node,
    NodeMetric,
    NodeMetricInfo,
    ObjectMeta,
    Pod,
    PodMetricInfo,
    PodSpec,
)
from koordinator_tpu_torch.api.resources import ResourceList
from koordinator_tpu_torch.models.scheduler_model import make_inputs
from koordinator_tpu_torch.ops.loadaware import (
    ANNOTATION_CUSTOM_USAGE_THRESHOLDS,
    build_loadaware_node_state,
)
from koordinator_tpu_torch.ops.packing import pack_nodes, pack_pods

GIB = 1024**3
MIB = 1024**2


@dataclass
class SynthCluster:
    nodes: List[Node]
    pods: List[Pod]                      # pending pods (unassigned)
    node_metrics: Dict[str, NodeMetric]  # by node name
    pods_by_key: Dict[str, Pod]          # running pods visible to listers
    assigned: Dict[str, List[Tuple[Pod, float]]] = field(default_factory=dict)
    now: float = 1_000_000.0


def synth_cluster(
    num_nodes: int,
    num_pods: int,
    seed: int = 0,
    now: float = 1_000_000.0,
    expired_fraction: float = 0.05,
    missing_metric_fraction: float = 0.05,
    custom_threshold_fraction: float = 0.1,
    aggregated_fraction: float = 0.3,
    with_pod_metrics: bool = True,
) -> SynthCluster:
    rng = random.Random(seed)
    nodes: List[Node] = []
    node_metrics: Dict[str, NodeMetric] = {}
    pods_by_key: Dict[str, Pod] = {}

    for i in range(num_nodes):
        cores = rng.choice([16, 32, 64, 96])
        mem_gib = cores * rng.choice([2, 4, 8])
        meta = ObjectMeta(name=f"node-{i}", namespace="")
        if rng.random() < custom_threshold_fraction:
            meta.annotations[ANNOTATION_CUSTOM_USAGE_THRESHOLDS] = (
                '{"usageThresholds": {"cpu": %d, "memory": %d}}'
                % (rng.choice([50, 70, 90]), rng.choice([80, 90]))
            )
        node = Node(
            meta=meta,
            allocatable=ResourceList.of(
                cpu=cores * 1000, memory=mem_gib * GIB, pods=110
            ),
        )
        nodes.append(node)

        if rng.random() < missing_metric_fraction:
            continue
        update_time = now - rng.uniform(1, 60)
        if rng.random() < expired_fraction:
            update_time = now - rng.uniform(200, 400)  # beyond 180s default expiry
        usage_cpu = int(cores * 1000 * rng.uniform(0.05, 0.9))
        usage_mem = int(mem_gib * GIB * rng.uniform(0.05, 0.9))
        info = NodeMetricInfo(
            node_usage=ResourceList.of(cpu=usage_cpu, memory=usage_mem)
        )
        if rng.random() < aggregated_fraction:
            info.aggregated_node_usages = {
                300: {
                    "p95": ResourceList.of(
                        cpu=int(usage_cpu * 1.1), memory=int(usage_mem * 1.05)
                    )
                },
                1800: {
                    "p95": ResourceList.of(
                        cpu=int(usage_cpu * 1.2), memory=int(usage_mem * 1.1)
                    ),
                    "p50": ResourceList.of(
                        cpu=int(usage_cpu * 0.8), memory=int(usage_mem * 0.9)
                    ),
                },
            }
        nm = NodeMetric(
            meta=ObjectMeta(name=f"node-{i}", namespace=""),
            update_time=update_time,
            node_metric=info,
        )
        if with_pod_metrics:
            for j in range(rng.randint(0, 4)):
                pod_name = f"running-{i}-{j}"
                prio = rng.choice([9500, 9500, 5500, 7500])
                running = Pod(
                    meta=ObjectMeta(name=pod_name, namespace="default"),
                    spec=PodSpec(node_name=f"node-{i}", priority=prio),
                    phase="Running",
                )
                pods_by_key[running.meta.key] = running
                nm.pods_metric.append(
                    PodMetricInfo(
                        namespace="default",
                        name=pod_name,
                        pod_usage=ResourceList.of(
                            cpu=rng.randint(50, 2000),
                            memory=rng.randint(64, 4096) * MIB,
                        ),
                    )
                )
        node_metrics[f"node-{i}"] = nm

    pods: List[Pod] = []
    for i in range(num_pods):
        kind = rng.random()
        if kind < 0.35:  # prod LS
            prio, qos = 9500, "LS"
        elif kind < 0.45:  # mid
            prio, qos = 7500, "LS"
        elif kind < 0.85:  # batch BE
            prio, qos = 5500, "BE"
        else:  # free BE
            prio, qos = 3500, "BE"
        cpu = rng.choice([0, 100, 250, 500, 1000, 2000, 4000])
        mem = rng.choice([0, 128, 256, 512, 1024, 4096, 8192]) * MIB
        limits = ResourceList()
        if rng.random() < 0.2 and cpu:
            limits = ResourceList.of(cpu=cpu * 2, memory=mem * 2 if mem else 0)
        meta = ObjectMeta(
            name=f"pod-{i}",
            namespace="default",
            labels={LABEL_POD_QOS: qos},
            creation_timestamp=now - rng.uniform(0, 3600),
        )
        if rng.random() < 0.05:
            meta.owner_kind = "DaemonSet"
            meta.owner_name = "ds"
        pods.append(
            Pod(
                meta=meta,
                spec=PodSpec(
                    priority=prio,
                    requests=ResourceList.of(cpu=cpu, memory=mem),
                    limits=limits,
                ),
            )
        )

    return SynthCluster(
        nodes=nodes,
        pods=pods,
        node_metrics=node_metrics,
        pods_by_key=pods_by_key,
        now=now,
    )


def loadaware_inputs(cluster: SynthCluster, args):
    """bench.py's default chain after the cluster: pack the pods and nodes,
    build the LoadAware node state, and return the round's ScheduleInputs
    as host numpy."""
    pods = pack_pods(cluster.pods, args.resource_weights,
                     args.estimated_scaling_factors)
    nodes = pack_nodes(cluster.nodes)
    nodes.extras = build_loadaware_node_state(
        cluster.nodes, cluster.node_metrics, cluster.pods_by_key,
        cluster.assigned, args, cluster.now, pad_to=nodes.padded_size)
    return make_inputs(pods, nodes, args)


def synth_full_cluster(
    num_nodes: int,
    num_pods: int,
    seed: int = 0,
    num_quotas: int = 8,
    num_gangs: int = 12,
    topology_fraction: float = 0.7,
    lsr_fraction: float = 0.15,
    taint_fraction: float = 0.0,
    **kwargs,
):
    """SynthCluster + ClusterState exercising the full chain: NUMA topologies,
    3-level quota tree, PodGroups, LSR cpuset pods (BASELINE configs 2-4)."""
    import json

    import numpy as np

    from koordinator_tpu_torch.api.objects import (
        LABEL_POD_GROUP,
        LABEL_QUOTA_NAME,
        LABEL_QUOTA_PARENT,
        LABEL_QUOTA_SHARED_WEIGHT,
        ElasticQuota,
        NodeResourceTopology,
        NUMAZone,
        PodGroup,
    )
    from koordinator_tpu_torch.scheduler.cpu_topology import CPUAllocationState, CPUTopology
    from koordinator_tpu_torch.scheduler.snapshot import ClusterState

    rng = random.Random(seed + 1000)
    cluster = synth_cluster(num_nodes, num_pods, seed=seed, **kwargs)

    topologies = {}
    cpu_states = {}
    for node in cluster.nodes:
        if rng.random() >= topology_fraction:
            continue
        cores_total = node.allocatable[("cpu")] // 1000 or 16
        cores_per_numa = max(2, int(cores_total) // (2 * 2))  # 2 numa, 2 threads
        topo = CPUTopology.build(1, 2, cores_per_numa, 2)
        mem = node.allocatable[("memory")]
        cr = NodeResourceTopology(
            meta=type(node.meta)(name=node.meta.name),
            cpus=topo.cpus,
            zones=[
                NUMAZone(
                    numa_id=k,
                    allocatable=ResourceList.of(
                        cpu=(len(topo.cpus) // 2) * 1000, memory=mem // 2
                    ),
                )
                for k in range(2)
            ],
            kubelet_cpu_manager_policy=rng.choice(
                ["none", "best-effort", "restricted", "single-numa-node"]
            ),
        )
        topologies[node.meta.name] = cr
        cpu_states[node.meta.name] = CPUAllocationState(topo)

    # 3-level quota tree: root -> team-i -> job-j
    quotas = []
    leaf_names = []
    if num_quotas > 0:
        quotas.append(
            ElasticQuota(
                meta=type(cluster.nodes[0].meta)(name="root"),
                min=ResourceList.of(cpu=0),
                max=ResourceList.of(cpu=10**9, memory=2**60),
            )
        )
        teams = max(1, num_quotas // 4)
        for t in range(teams):
            meta = type(cluster.nodes[0].meta)(name=f"team-{t}")
            meta.labels[LABEL_QUOTA_PARENT] = "root"
            meta.annotations[LABEL_QUOTA_SHARED_WEIGHT] = json.dumps(
                {"cpu": str(rng.randint(1, 5)), "memory": f"{rng.randint(64, 512)}Gi"}
            )
            quotas.append(
                ElasticQuota(
                    meta=meta,
                    min=ResourceList.of(
                        cpu=rng.randint(8, 64) * 1000,
                        memory=rng.randint(16, 128) * GIB,
                    ),
                    max=ResourceList.of(cpu=10**9, memory=2**60),
                )
            )
        for q in range(num_quotas - teams - 1):
            meta = type(cluster.nodes[0].meta)(name=f"job-{q}")
            meta.labels[LABEL_QUOTA_PARENT] = f"team-{q % teams}"
            quotas.append(
                ElasticQuota(
                    meta=meta,
                    min=ResourceList.of(
                        cpu=rng.randint(0, 32) * 1000,
                        memory=rng.randint(0, 64) * GIB,
                    ),
                    max=ResourceList.of(
                        cpu=rng.randint(64, 256) * 1000,
                        memory=rng.randint(256, 1024) * GIB,
                    ),
                )
            )
            leaf_names.append(meta.name)

    pod_groups = [
        PodGroup(
            meta=type(cluster.nodes[0].meta)(name=f"gang-{g}"),
            min_member=rng.randint(2, 6),
        )
        for g in range(num_gangs)
    ]

    # decorate pods: quotas, gangs, LSR cpuset pods
    from koordinator_tpu_torch.api.objects import LABEL_POD_QOS

    for pod in cluster.pods:
        r = rng.random()
        if leaf_names and r < 0.5:
            pod.meta.labels[LABEL_QUOTA_NAME] = rng.choice(leaf_names)
        if pod_groups and rng.random() < 0.3:
            pod.meta.labels[LABEL_POD_GROUP] = rng.choice(pod_groups).meta.name
        if rng.random() < lsr_fraction:
            pod.meta.labels[LABEL_POD_QOS] = "LSR"
            cores = rng.choice([2, 4])
            pod.spec.requests = ResourceList.of(
                cpu=cores * 1000, memory=pod.spec.requests[("memory")] or GIB
            )
            pod.spec.limits = ResourceList()

    # taints: a fraction of nodes dedicated to a pool; a fraction of pods
    # tolerate each pool (TaintToleration coverage)
    if taint_fraction > 0:
        pools = ["infra", "gpu"]
        for node in cluster.nodes:
            if rng.random() < taint_fraction:
                node.taints = [("dedicated", rng.choice(pools))]
        for pod in cluster.pods:
            r = rng.random()
            if r < 0.2:
                pod.spec.tolerations = [("dedicated", rng.choice(pools))]
            elif r < 0.25:
                pod.spec.tolerations = [("dedicated", "")]  # wildcard

    state = ClusterState(
        nodes=cluster.nodes,
        pending_pods=cluster.pods,
        node_metrics=cluster.node_metrics,
        pods_by_key=cluster.pods_by_key,
        assigned=cluster.assigned,
        topologies=topologies,
        cpu_states=cpu_states,
        quotas=quotas,
        pod_groups=pod_groups,
        now=cluster.now,
    )
    return cluster, state


ZONE = "topology.kubernetes.io/zone"


def decorate_mixed(state, seed: int):
    """Decorate a synth_full_cluster state with EVERY scheduling feature the
    full-chain round handles: zone/pool/disk labels, node reservations, CSI
    volume limits, images, symmetric anti-affinity and hostPorts on running
    pods, and on pending pods hostPorts, CSI claims (fresh and shared with a
    running pod, so volume groups > 1), images, nodeSelectors, required pod
    affinity/anti-affinity, both spread modes, preferred node and pod
    affinity. The random part is the cross-feature parity fixture of the JAX
    package's tests (tests/test_parity_fuzz.py), identical to it at 30 nodes
    (tests/test_torch_pack.py holds the two packs equal); a last pass makes
    sure each feature is carried by at least one pending pod, so every switch
    of the kernel (T, S, S2, PT, SI > 0 and VG > 1) is live at any size."""
    import json

    from koordinator_tpu_torch.api import objects

    rng = random.Random(seed)
    for j, node in enumerate(state.nodes):
        node.meta.labels[ZONE] = f"z{j % 4}"
        node.meta.labels["pool"] = rng.choice(["gold", "silver"])
        node.meta.labels["disk"] = rng.choice(["ssd", "hdd"])
        if rng.random() < 0.1:
            node.meta.annotations[objects.ANNOTATION_NODE_RESERVATION] = (
                json.dumps({"resources": {"cpu": "1", "memory": "1Gi"}}))
    for j, node in enumerate(state.nodes):
        if rng.random() < 0.2:
            node.attachable_volume_limit = rng.choice([2, 4])
        if rng.random() < 0.4:
            node.images["registry/web:v2"] = 300 * MIB
    apps = ["web", "db", "cache"]
    running = [p for p in state.pods_by_key.values()
               if p.is_assigned and not p.is_terminated]
    # running anti-affinity carriers repel every matching pending pod from
    # their whole zone: the fixture's 10% at 30 nodes, thinned past that so
    # that a large cluster keeps zones free for each app
    anti_p = 0.1 * min(1.0, 30.0 / max(len(state.nodes), 1))
    for pod in running:
        if rng.random() < anti_p:
            pod.spec.pod_anti_affinity.append(objects.PodAffinityTerm(
                selector={"app": rng.choice(apps)}, topology_key=ZONE))
        if rng.random() < 0.1:
            pod.spec.host_ports.append(("TCP", rng.choice([80, 443, 8080])))

    def share_claim(i, pod):
        donor = rng.choice(running)
        if not donor.spec.pvc_names:
            donor.spec.pvc_names = [f"shared-{i}"]
        pod.spec.pvc_names = list(donor.spec.pvc_names)
        pod.meta.namespace = donor.meta.namespace

    for i, pod in enumerate(state.pending_pods):
        r = rng.random()
        app = rng.choice(apps)
        pod.meta.labels["app"] = app
        if rng.random() < 0.15:
            pod.spec.host_ports.append(("TCP", rng.choice([80, 443, 8080])))
        if rng.random() < 0.15:
            pod.spec.pvc_names = [f"claim-{i}"]
        elif rng.random() < 0.1 and running:
            share_claim(i, pod)
        if rng.random() < 0.2:
            pod.spec.images = ["registry/web:v2"]
        if r < 0.15:
            pod.spec.node_selector["pool"] = rng.choice(["gold", "silver"])
        elif r < 0.3:
            pod.spec.pod_anti_affinity.append(objects.PodAffinityTerm(
                selector={"app": app}, topology_key=ZONE))
        elif r < 0.45:
            pod.spec.pod_affinity.append(objects.PodAffinityTerm(
                selector={"app": rng.choice(apps)}, topology_key=ZONE))
        elif r < 0.6:
            pod.spec.topology_spread.append(objects.TopologySpreadConstraint(
                max_skew=rng.choice([1, 2]), topology_key=ZONE,
                selector={"app": app},
                when_unsatisfiable=rng.choice(
                    ["DoNotSchedule", "ScheduleAnyway"])))
        elif r < 0.75:
            pod.spec.affinity_preferred.append(objects.PreferredNodeTerm(
                weight=rng.randint(1, 100), labels={"disk": "ssd"}))
        elif r < 0.9:
            pod.spec.pod_affinity_preferred.append(objects.PreferredPodTerm(
                weight=rng.choice([-50, 40, 80]),
                selector={"app": rng.choice(apps)}, topology_key=ZONE))

    # every feature on at least one pending pod (the kernel's switches)
    pending = state.pending_pods
    spec = [p.spec for p in pending]
    if pending and not any(s.host_ports for s in spec):
        spec[0].host_ports.append(("TCP", 8080))
    if pending and not any(s.images for s in spec):
        spec[min(1, len(spec) - 1)].images = ["registry/web:v2"]
    if pending and not any(s.affinity_preferred for s in spec):
        spec[min(2, len(spec) - 1)].affinity_preferred.append(
            objects.PreferredNodeTerm(weight=50, labels={"disk": "ssd"}))
    if pending and not any(s.pod_affinity_preferred for s in spec):
        spec[min(3, len(spec) - 1)].pod_affinity_preferred.append(
            objects.PreferredPodTerm(weight=40, selector={"app": "web"},
                                     topology_key=ZONE))
    if pending and not any(
            c.when_unsatisfiable == "DoNotSchedule"
            for s in spec for c in s.topology_spread):
        pod = pending[min(4, len(pending) - 1)]
        pod.spec.topology_spread.append(objects.TopologySpreadConstraint(
            max_skew=1, topology_key=ZONE,
            selector={"app": pod.meta.labels["app"]},
            when_unsatisfiable="DoNotSchedule"))
    if pending and running and not any(
            s.pvc_names and s.pvc_names[0].startswith("shared-")
            for s in spec):
        share_claim(len(pending), pending[min(5, len(pending) - 1)])
    return state


def mixed_cluster(seed: int, num_nodes: int = 30, num_pods: int = 60):
    """(cluster, state): synth_full_cluster with 20% tainted nodes, then
    decorate_mixed — every static branch of the full-chain kernel live."""
    cluster, state = synth_full_cluster(num_nodes, num_pods, seed=seed,
                                        taint_fraction=0.2)
    decorate_mixed(state, seed)
    return cluster, state
