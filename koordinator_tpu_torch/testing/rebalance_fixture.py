"""The BASELINE config 5 store: koord-descheduler LowNodeLoad over running
pods (BASELINE.json "koord-descheduler LowNodeLoad: 50k running pods
global rebalance").

A copy of the JAX package's bench.py ``_build_rebalance_fixture`` (the
same ``random.Random(7)`` draws in the same order, so both packages get
the same store) with the port's imports:

    store = rebalance_store(50_000, 5_000, now)

30% of the nodes read overloaded (85% cpu and memory), 40% underloaded
(20%), 30% in band (60%); pods are spread round-robin over the nodes,
each Running under a ReplicaSet with a priority of 5500, 6500 or 9000
and a request of 500/1000/2000 milli-cpu and 1/2/4 GiB.
"""

from __future__ import annotations

import random

from koordinator_tpu_torch.api.objects import (
    Node,
    NodeMetric,
    NodeMetricInfo,
    ObjectMeta,
    Pod,
    PodSpec,
)
from koordinator_tpu_torch.api.resources import ResourceList
from koordinator_tpu_torch.client.store import (
    KIND_NODE,
    KIND_NODE_METRIC,
    KIND_POD,
    ObjectStore,
)

GIB = 1024 ** 3


def rebalance_store(num_pods: int, num_nodes: int,
                    now: float) -> ObjectStore:
    """num_pods RUNNING pods on num_nodes nodes, metrics fresh at ``now``
    (updated 30 s before it)."""
    rng = random.Random(7)
    store = ObjectStore()
    for i in range(num_nodes):
        cores = 32
        band = 85.0 if i % 10 < 3 else (20.0 if i % 10 < 7 else 60.0)
        store.add(KIND_NODE, Node(
            meta=ObjectMeta(name=f"node-{i}", namespace=""),
            allocatable=ResourceList.of(cpu=cores * 1000, memory=128 * GIB,
                                        pods=256),
        ))
        store.add(KIND_NODE_METRIC, NodeMetric(
            meta=ObjectMeta(name=f"node-{i}", namespace=""),
            update_time=now - 30,
            node_metric=NodeMetricInfo(
                node_usage=ResourceList.of(
                    cpu=int(cores * 1000 * band / 100),
                    memory=int(128 * GIB * band / 100),
                )
            ),
        ))
    for p in range(num_pods):
        node_idx = p % num_nodes
        prio = rng.choice([5500, 6500, 9000])
        store.add(KIND_POD, Pod(
            meta=ObjectMeta(name=f"pod-{p}", uid=f"uid-{p}",
                            owner_kind="ReplicaSet", owner_name=f"rs-{p % 97}",
                            creation_timestamp=now - 3600),
            spec=PodSpec(node_name=f"node-{node_idx}", priority=prio,
                         requests=ResourceList.of(
                             cpu=rng.choice([500, 1000, 2000]),
                             memory=rng.choice([1, 2, 4]) * GIB)),
            phase="Running",
        ))
    return store
