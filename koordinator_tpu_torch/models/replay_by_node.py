"""The plain version of the node-parallel replay kernel (csrc/
replay_by_node.cu, launched by ops/full_chain_kernel.full_chain_replay):
models/fused_waves.replay_kept's result by the kernel's decomposition, in
plain torch. The tests hold it against replay_kept, the JAX fused step's
replay and, per card, parallel/full_chain_mesh.sharded_replay_kept; on the
card the kernel is held against replay_kept itself.
"""

from __future__ import annotations

import torch

from koordinator_tpu_torch.models.full_chain import commit_node_rows
from koordinator_tpu_torch.ops.numa import numa_zone_for_node

# every addend of the affinity counts is 1.0: their sum is exact up to here
COUNT_LIMIT = 2**24


def _cell_sum(acc, vals):
    """``acc`` plus the rows of ``vals`` one after another: a quota cell's
    adds, in the order given."""
    for v in vals:
        acc = acc + v
    return acc


def replay_by_node(fc_carry, prod_mode: bool, state, chosen, kept, *,
                   shards=(0,), per=None, dom_rows=None):
    """The plain version of the node-parallel replay (csrc/
    replay_by_node.cu): replay_kept's result by the kernel's decomposition.

    The kept pods are bucketed by node, each bucket in queue order, and
    every node commits its own (commit_node_rows, the zone re-picked under
    the node's running state); each quota cell adds the requests (times
    the chain's multiplicity) of the kept pods whose chain holds its group,
    in queue order (``_cell_sum``); each (term, domain) counts the kept
    pods that match the term (and, apart, those that carry it as required
    anti-affinity), and every node adds its domain's counts once. That add
    equals replay_kept's one-by-one adds of 1.0 only while the counts are
    integers below 2^24: past that this raises ValueError (the kernel adds
    those ones one by one instead).

    Arguments as replay_kept's; over a mesh of cards ``fc_carry`` and
    ``state`` are a card's view (``shards``' rows side by side, ``per``
    each) and ``dom_rows`` [P, T] the chosen nodes' aff_dom rows. Returns
    (state', zones[P], -1 outside the kept pods whose node these rows
    hold)."""
    inputs = fc_carry.base
    P, R = inputs.fit_requests.shape
    N = inputs.allocatable.shape[0]
    per = N if per is None else int(per)
    dev = chosen.device
    T = fc_carry.aff_dom.shape[1]
    (requested, est_sum, est_pr, numa_free, bind_free, quota_used,
     aff_count, anti_cover, aff_exists, port_used, vol_free) = state
    if est_pr is None:
        est_pr = torch.zeros((N, R), dtype=torch.float32, device=dev)
    st = tuple(t.clone() for t in (
        requested, est_sum, est_pr, numa_free, bind_free, quota_used,
        aff_count, anti_cover, aff_exists.to(torch.bool), port_used,
        vol_free))
    zones = torch.full((P,), -1, dtype=torch.int32, device=dev)
    kept_idx = torch.nonzero(kept).flatten().tolist()
    g_all = torch.clamp_min(chosen.to(torch.int64), 0).tolist()
    row_of = {int(k): l for l, k in enumerate(shards)}

    # ---- each node's kept pods, in queue order
    buckets = {}
    for i in kept_idx:
        k, b = divmod(g_all[i], per)
        if k in row_of:
            buckets.setdefault(row_of[k] * per + b, []).append(i)
    yes = torch.ones((), dtype=torch.bool, device=dev)
    for n, pods in buckets.items():
        for i in pods:
            zone = numa_zone_for_node(fc_carry.requests[i],
                                      fc_carry.needs_numa[i], st[3][n],
                                      fc_carry.numa_policy[n])
            commit_node_rows(fc_carry, prod_mode, st, i, yes, n, zone)
            zones[i] = zone

    # ---- each quota cell, the kept pods of its group in queue order
    anc = fc_carry.quota_ancestors.to(torch.int64)
    G = anc.shape[0]
    mult = (anc[:, :, None] == torch.arange(G, device=anc.device)).sum(1)
    mult_l = mult.tolist()
    qid = fc_carry.quota_id.to(torch.int64).tolist()
    quota = st[5]
    for g in range(G):
        pods = [i for i in kept_idx
                if 0 <= qid[i] < G and mult_l[qid[i]][g] > 0]
        if pods:
            m = mult[[qid[i] for i in pods], g].to(torch.float32)
            vals = m[:, None] * fc_carry.requests[pods].to(torch.float32)
            quota[g] = _cell_sum(quota[g], vals)

    # ---- the affinity counts per (term, domain), added once per node
    if kept_idx and T:
        rows = (dom_rows[kept_idx] if dom_rows is not None
                else fc_carry.aff_dom[[g_all[i] for i in kept_idx]])
        match = fc_carry.pod_aff_match[kept_idx].to(torch.bool)
        anti = fc_carry.pod_anti_req[kept_idx].to(torch.bool)
        st[8][:] = st[8] | match.any(dim=0)
        for t in range(T):
            node_dom = fc_carry.aff_dom[:, t]
            for flags, slot in ((match[:, t], 6), (anti[:, t], 7)):
                doms = rows[:, t][flags & (rows[:, t] >= 0)]
                # the count of each node's domain among the pods' domains
                c = (node_dom[:, None] == doms[None, :]).sum(dim=1)
                c = torch.where(node_dom >= 0, c, 0).to(torch.float32)
                x = st[slot][:, t]
                bad = (c > 0) & ((x < 0) | (x != torch.floor(x))
                                 | (x + c > COUNT_LIMIT))
                if bool(bad.any()):
                    raise ValueError(
                        f"replay_by_node: an affinity count of term {t} "
                        f"leaves the integers below 2^24, where one add per "
                        f"domain stops equalling the per-pod adds")
                st[slot][:, t] = x + c
    return st, zones
