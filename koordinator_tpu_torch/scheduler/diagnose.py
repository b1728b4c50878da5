"""Unschedulability diagnosis: why did the kernel leave a pod unbound?

The reference surfaces every filter failure in pod status through the
scheduler framework (the '0/N nodes are available: X Insufficient cpu...'
message kube-scheduler writes to the PodScheduled condition, and
frameworkext's debug plumbing reference pkg/scheduler/frameworkext/
debug.go:31-46). The batched kernel returns only `chosen[i] == -1`, so
this module re-runs the SAME per-stage predicates in numpy against the
batch's packed arrays — pre-batch state, one pod at a time — and
aggregates per-stage failure counts into the upstream-style message.

Cost: O(N x R) per diagnosed pod, run host-side only for pods that END a
cycle unbound (typically few); the kernel pass itself is untouched.

Caveat, documented: the breakdown is computed against the CYCLE-START
state (before in-batch placements), so a pod starved by earlier pods in
the same batch reports the stage that failed at batch start — the same
approximation upstream makes when it diagnoses against the informer
snapshot rather than the in-flight assume cache.

koordexplain split: the module is now counts + formatter. The
kernel emits the same per-stage counts on device in the scheduling
dispatch (models/full_chain.explain_stage_counts, KOORD_TPU_EXPLAIN);
``format_stage_counts`` renders EITHER source into the identical message,
and ``host_stage_counts`` (this module's numpy recompute) stays as the
parity oracle tier-1 diffs the kernel counts against.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from koordinator_tpu_torch.models.full_chain import (
    EXPLAIN_STAGE_GANG,
    EXPLAIN_STAGE_QUOTA,
    EXPLAIN_STAGES,
    NUM_EXPLAIN_STAGES,
)

GANG_MESSAGE = ("gang minMember not satisfied: sibling pods missing or the "
                "gang timed out (Coscheduling PreFilter)")
QUOTA_MESSAGE = ("quota group exhausted: request exceeds runtime "
                 "quota along the ancestor chain (ElasticQuota "
                 "PreFilter)")


def _count(mask) -> int:
    return int(np.asarray(mask).sum())


def format_stage_counts(counts, num_nodes: int) -> str:
    """The upstream-style message for one pod's stage-count vector
    (NUM_EXPLAIN_STAGES long, kernel- or host-computed — the SAME formatter
    renders both, so parity between them reduces to count equality).
    Reproduces the legacy diagnose_unbound byte-for-byte: PreFilter
    verdicts short-circuit (gang before quota, the legacy early returns),
    then non-zero per-node stages sort by descending count with the
    taxonomy order breaking ties (Python's stable sort + EXPLAIN_STAGES
    insertion order)."""
    counts = np.asarray(counts)
    if int(counts[EXPLAIN_STAGE_GANG]):
        return GANG_MESSAGE
    if int(counts[EXPLAIN_STAGE_QUOTA]):
        return QUOTA_MESSAGE
    parts: List[str] = [
        f"{int(c)} {label}"
        for label, c in zip(EXPLAIN_STAGES, counts)
        if int(c)
    ]
    parts.sort(key=lambda s: -int(s.split(" ", 1)[0]))
    if not parts:
        # every stage we model passes on some node at cycle-start state:
        # the pod lost to in-batch contention (capacity taken by earlier
        # queue positions this cycle)
        return (f"0/{num_nodes} nodes available after in-batch placements: "
                "capacity consumed by earlier pods this cycle")
    return f"0/{num_nodes} nodes are available: " + ", ".join(parts) + "."


def shared_state(fc, num_nodes: int) -> dict:
    """Node-level inputs every diagnosis of this batch shares, computed
    ONCE: the LoadAware reject rows, by the host twin of the round's own
    rows (ops/loadaware.loadaware_node_reject_np, op for op in f32; paying
    it per unbound pod made a many-unbound cycle quadratically
    expensive)."""
    from koordinator_tpu_torch.ops.loadaware import loadaware_node_reject_np

    inputs = fc.base
    n = num_nodes
    rej_np, rej_pr = loadaware_node_reject_np(*(np.asarray(a) for a in (
        inputs.allocatable, inputs.la_filter_usage,
        inputs.la_has_filter_usage, inputs.la_filter_thresholds,
        inputs.la_prod_thresholds, inputs.la_prod_pod_usage,
        inputs.la_filter_skip)))
    return {
        "alloc": np.asarray(inputs.allocatable, np.float32)[:n],
        "requested": np.asarray(inputs.requested, np.float32)[:n],
        "node_ok": np.asarray(inputs.node_ok, bool)[:n],
        "rej_np": np.asarray(rej_np, bool)[:n],
        "rej_pr": np.asarray(rej_pr, bool)[:n],
    }


def _stage_verdicts(fc, i: int, num_nodes: int, shared: dict = None):
    """The per-stage verdicts behind one pod's diagnosis: a pod-level
    PreFilter flag pair (gang invalid, quota exhausted) plus the per-node
    reject masks keyed by EXPLAIN_STAGES label. Shared by the counts
    oracle (host_stage_counts) and the feasibility view
    (host_feasible_mask) so the two can never drift."""
    inputs = fc.base
    n = num_nodes
    if shared is None:
        shared = shared_state(fc, n)
    alloc = shared["alloc"]
    requested = shared["requested"]
    node_ok = shared["node_ok"]
    fit_req = np.asarray(inputs.fit_requests, np.float32)[i]
    raw_req = np.asarray(fc.requests, np.float32)[i]

    # ---- PreFilter stage (pod-level verdict flags; no node breakdown)
    gang_bad = False
    quota_bad = False
    gang_id = int(np.asarray(fc.gang_id)[i])
    if gang_id >= 0 and not bool(np.asarray(fc.gang_valid)[gang_id]):
        gang_bad = True
    qid = int(np.asarray(fc.quota_id)[i])
    if qid >= 0:
        used = np.asarray(fc.quota_used, np.float32)
        runtime = np.asarray(fc.quota_runtime, np.float32)
        chain = np.asarray(fc.quota_ancestors)[qid]
        for g in chain:
            if g < 0:
                continue
            bad = (raw_req > 0) & (used[g] + raw_req > runtime[g])
            if bad.any():
                quota_bad = True
                break

    # ---- Filter stages, counted per node
    reasons: Dict[str, np.ndarray] = {}
    reasons["node not schedulable"] = ~node_ok
    # admission bitmask: taints + nodeSelector/affinity + volume topology
    mask = int(np.asarray(fc.pod_taint_mask)[i])
    group = np.asarray(fc.node_taint_group)[:n]
    reasons["taint/selector/volume-topology mismatch"] = (
        ((mask >> group) & 1) == 0)
    # NodeResourcesFit
    reasons["insufficient resources"] = (
        (fit_req[None, :] > 0) & (requested + fit_req[None, :] > alloc)
    ).any(axis=1)
    # LoadAware thresholds (node rows precomputed in shared_state)
    is_prod = bool(np.asarray(inputs.is_prod)[i])
    is_ds = bool(np.asarray(inputs.is_daemonset)[i])
    la_rej = shared["rej_pr"] if is_prod else shared["rej_np"]
    reasons["node load over threshold"] = (
        la_rej if not is_ds else np.zeros(n, bool))
    # NodePorts
    wants = np.asarray(fc.pod_port_wants, bool)[i]
    if wants.any():
        used_ports = np.asarray(fc.port_used, np.float32)[:n]
        reasons["hostPort in use"] = (
            used_ports[:, wants] > 0).any(axis=1)
    # CSI volume limits (volume-group row selects new attachments)
    vn_row = np.asarray(fc.vol_needed, np.float32)[i]
    if (vn_row > 0).any():
        vg = np.asarray(fc.node_vol_group)[:n]
        vn = vn_row[vg]
        reasons["CSI volume limit exceeded"] = (
            (vn > 0) & (np.asarray(fc.vol_free, np.float32)[:n] < vn))
    # cpuset capacity
    if bool(np.asarray(fc.needs_bind)[i]):
        cores = float(np.asarray(fc.cores_needed)[i])
        bind_free = np.asarray(fc.bind_free, np.float32)[:n]
        has_topo = np.asarray(fc.has_topology, bool)[:n]
        cpc = np.maximum(np.asarray(fc.cpus_per_core, np.float32)[:n], 1.0)
        bad = ~has_topo | (cores > bind_free)
        if bool(np.asarray(fc.full_pcpus)[i]):
            bad |= np.remainder(cores, cpc) != 0
        reasons["insufficient bindable CPUs"] = bad
    # NUMA topology
    if bool(np.asarray(fc.needs_numa)[i]):
        numa_free = np.asarray(fc.numa_free, np.float32)[:n]
        policy = np.asarray(fc.numa_policy)[:n]
        per_zone_fit = (
            (raw_req[None, None, :] <= 0)
            | (raw_req[None, None, :] <= numa_free)).all(axis=2).any(axis=1)
        total_fit = (
            (raw_req[None, :] <= 0)
            | (raw_req[None, :] <= numa_free.sum(axis=1))).all(axis=1)
        reasons["NUMA topology cannot fit"] = np.where(
            policy == 1, ~per_zone_fit, (policy != 0) & ~total_fit)
    # inter-pod affinity / anti-affinity / spread (aggregate), mirroring
    # the kernel predicates in models/full_chain.py make_pod_evaluator
    T = fc.aff_dom.shape[1]
    if T:
        aff_bad = np.zeros(n, bool)
        dom = np.asarray(fc.aff_dom, np.float32)[:n]
        count = np.asarray(fc.aff_count, np.float32)[:n]
        cover = np.asarray(fc.anti_cover, np.float32)[:n]
        exists = np.asarray(fc.aff_exists, bool)
        taint_ok = ~reasons["taint/selector/volume-topology mismatch"]
        skew_row = np.asarray(fc.pod_spread_skew, np.float32)[i]
        for t in range(T):
            match_t = bool(np.asarray(fc.pod_aff_match)[i, t])
            if bool(np.asarray(fc.pod_anti_req)[i, t]):
                aff_bad |= count[:, t] > 0
            if match_t:
                aff_bad |= cover[:, t] > 0
            if bool(np.asarray(fc.pod_aff_req)[i, t]):
                # bootstrap admits a self-matching first replica only when
                # NO matching pod exists anywhere; otherwise the node needs
                # a matching pod in a valid domain
                bootstrap = match_t and not exists[t]
                if not bootstrap:
                    aff_bad |= ~((dom[:, t] >= 0) & (count[:, t] > 0))
            skew = float(skew_row[t])
            if skew > 0:
                dom_valid = dom[:, t] >= 0
                eligible = dom_valid & taint_ok
                min_count = (count[eligible, t].min()
                             if eligible.any() else np.inf)
                self_m = 1.0 if match_t else 0.0
                aff_bad |= ~(dom_valid
                             & (count[:, t] + self_m - min_count <= skew))
        reasons["affinity/anti-affinity/spread mismatch"] = aff_bad

    return gang_bad, quota_bad, reasons


def host_stage_counts(fc, i: int, num_nodes: int,
                      shared: dict = None) -> np.ndarray:
    """[NUM_EXPLAIN_STAGES] uint32 for pod row ``i`` of FullChainInputs
    ``fc``: per-stage rejected-node counts over the first ``num_nodes``
    real (unpadded) nodes plus the gang/quota PreFilter verdict flags —
    the host-numpy oracle the kernel's on-device attribution is diffed
    against. Pass ``shared`` (shared_state) when diagnosing many pods of
    one batch."""
    gang_bad, quota_bad, reasons = _stage_verdicts(fc, i, num_nodes,
                                                  shared=shared)
    counts = np.zeros(NUM_EXPLAIN_STAGES, np.uint32)
    if gang_bad:
        counts[EXPLAIN_STAGE_GANG] = 1
    if quota_bad:
        counts[EXPLAIN_STAGE_QUOTA] = 1
    for s, label in enumerate(EXPLAIN_STAGES):
        bad = reasons.get(label)
        if bad is not None:
            counts[s] = _count(bad)
    return counts


def host_feasible_mask(fc, i: int, num_nodes: int,
                       shared: dict = None) -> np.ndarray:
    """bool[num_nodes]: the nodes on which pod row ``i`` passes every
    modeled PreFilter/Filter predicate at ``fc``'s state — the
    complement union of the same per-stage verdicts the counts oracle
    reports. The degradation ladder's host-fallback pass
    (scheduler/degrade.host_fallback_schedule) schedules against this
    view when the device dispatch is down."""
    gang_bad, quota_bad, reasons = _stage_verdicts(fc, i, num_nodes,
                                                  shared=shared)
    if gang_bad or quota_bad:
        return np.zeros(num_nodes, bool)
    feasible = np.ones(num_nodes, bool)
    for bad in reasons.values():
        feasible &= ~np.asarray(bad, bool)
    return feasible


def diagnose_unbound(fc, i: int, num_nodes: int,
                     shared: dict = None) -> str:
    """Upstream-style message for pod row ``i`` of FullChainInputs ``fc``:
    the legacy host-numpy recompute path — host counts through the shared
    formatter. The explain-enabled cycle driver formats KERNEL counts with
    the same formatter instead; tier-1 pins the two string-for-string."""
    return format_stage_counts(
        host_stage_counts(fc, i, num_nodes, shared=shared), num_nodes)
