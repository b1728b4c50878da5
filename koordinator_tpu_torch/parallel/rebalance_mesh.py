"""Mesh-sharded rebalance pass: the descheduler's pass over the mesh.

The port's counterpart of the JAX package's parallel/rebalance_mesh.py
(``build_rebalance_step``, balance/step.py, over the device mesh). The
node-axis inputs (usage/metric columns and the rhs limbs, ``rb_*`` fields
of the mesh-backed DeviceSnapshot) arrive sharded, the pod arrays
replicated. Each shard classifies its own node rows
(balance/step.classify_rows); the classified rows and the rhs limbs are
gathered into whole columns (an all-gather: within a process the local
shards side by side, on a mesh of cards on the first shard's card —
the pass is small and the JAX step is XLA, not a kernel — across
processes over gloo), and the pod-axis part —
the candidate mask, the stable victim order, the freed prefix and the
greedy selection (balance/step.select_victims) — runs on every process's
replica over the gathered columns, in the single-device order. The
outputs are that replica: bit for bit the single-device pass, gated by
``pipeline_parity.run_rebalance_parity(ndev)``.
"""

from __future__ import annotations

import torch

from koordinator_tpu_torch.parallel.mesh import (
    Mesh,
    ShardedTensor,
    cat_over_processes,
)


def gather_rows(mesh: Mesh, per_shard) -> torch.Tensor:
    """Whole node columns from per-shard rows (k -> tensor, this
    process's shards): the local shards side by side (on a mesh of cards,
    each card's rows copied to the first shard's card), and across the
    processes of a mesh that spans them an all-gather (gloo) in shard
    order."""
    keys = sorted(per_shard)
    first = per_shard[keys[0]].device
    return cat_over_processes(
        mesh, torch.cat([per_shard[k].to(first) for k in keys]))


def local_shards(x):
    """k -> shard tensor of a node-sharded ShardedTensor, or the local
    replica of a replicated one (a plain tensor passes through)."""
    if isinstance(x, ShardedTensor):
        if x.replicated:
            return x.local()
        return {k: t for k, t in enumerate(x.shards) if t is not None}
    return x


def build_sharded_rebalance_step(max_evict_per_node: int, mesh: Mesh):
    """The rebalance pass over ``mesh``: the step takes the pass's inputs
    (balance/step.STEP_FIELDS order) as the mesh-backed DeviceSnapshot
    uploads them (node fields sharded, the rest replicated) and returns
    RebalanceOut on this process's replica."""
    from koordinator_tpu_torch.balance.step import (
        STEP_FIELDS,
        classify_rows,
        select_victims,
    )

    cap = int(max_evict_per_node)

    def step(*args):
        if len(args) != len(STEP_FIELDS):
            raise TypeError(f"rebalance step takes {len(STEP_FIELDS)} "
                            f"arrays, got {len(args)}")
        (usage_pct, has_metric, low_thr, high_thr, rhs_hi, rhs_lo,
         pod_node, pod_prio, pod_cpu, pod_req_i,
         pod_ok) = (local_shards(a) for a in args)
        rows = {k: classify_rows(usage_pct[k], has_metric[k], low_thr,
                                 high_thr) for k in usage_pct}
        is_low, is_high, margin, over_gate = (
            gather_rows(mesh, {k: r[j] for k, r in rows.items()})
            for j in range(4))
        return select_victims(cap, is_low, is_high, margin, over_gate,
                              high_thr, gather_rows(mesh, rhs_hi),
                              gather_rows(mesh, rhs_lo), pod_node,
                              pod_prio, pod_cpu, pod_req_i, pod_ok)

    return step
