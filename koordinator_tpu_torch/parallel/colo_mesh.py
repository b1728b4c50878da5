"""Mesh-sharded colo pass: the manager's pass over the mesh.

The port's counterpart of the JAX package's parallel/colo_mesh.py
(``build_colo_step``, colo/step.py, over the device mesh). The node-axis
inputs (the NodeResource pipeline columns and the degrade mask, ``colo_*``
fields of the mesh-backed DeviceSnapshot) arrive sharded, the quota-tree
arrays replicated. Each shard computes its rows' batch/mid columns
(colo/step.node_columns, row by row); the columns are gathered whole (the
local shards side by side, on a mesh of cards onto the first shard's
card, across processes an all-gather over gloo), so
the predicted total's f32 column sums reduce in the single-device order
rather than as per-shard partial sums; the quota fold
(colo/step.quota_fold) runs on every process's replica. The outputs are
that replica: bit for bit the single-device pass, gated by
``pipeline_parity.run_colo_parity(ndev)``.
"""

from __future__ import annotations

from typing import Sequence

from koordinator_tpu_torch.parallel.mesh import Mesh
from koordinator_tpu_torch.parallel.rebalance_mesh import (
    gather_rows,
    local_shards,
)


def build_sharded_colo_step(cpu_policy: str, memory_policy: str,
                            mesh: Mesh, scale_min_enabled: bool = True):
    """The colo pass over ``mesh``: ``step(*arrays, plan=...)`` takes the
    pass's inputs (colo/step.STEP_FIELDS order) as the mesh-backed
    DeviceSnapshot uploads them and returns ColoOut on this process's
    replica."""
    import torch

    from koordinator_tpu_torch.colo.step import (
        COLO_NODE_ARGS,
        STEP_FIELDS,
        node_columns,
        quota_fold,
    )

    n_node = len(COLO_NODE_ARGS)

    def step(*args, plan: Sequence[int]):
        if len(args) != len(STEP_FIELDS):
            raise TypeError(f"colo step takes {len(STEP_FIELDS)} arrays, "
                            f"got {len(args)}")
        node = [local_shards(a) for a in args[:n_node]]
        rows = {k: node_columns(cpu_policy, memory_policy,
                                *(a[k] for a in node))
                for k in node[0]}
        cols = gather_rows(mesh, {k: r[0] for k, r in rows.items()})
        n_degraded = torch.stack([r[1].to(cols.device)
                                  for r in rows.values()]).sum(
            dtype=torch.int32)
        n_degraded = mesh.all_reduce(n_degraded.reshape(1), "sum")[0]
        return quota_fold(cols, n_degraded,
                          *(local_shards(a) for a in args[n_node:]),
                          plan=plan, scale_min_enabled=scale_min_enabled)

    return step
