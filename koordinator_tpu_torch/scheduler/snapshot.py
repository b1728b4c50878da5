"""Cluster snapshot builder: cluster objects -> FullChainInputs (numpy).

The analog of the scheduler's cache/snapshot layer plus every plugin's
PreFilter precompute (SURVEY.md section 3.1): one pass over nodes, pods and
CRs produces the packed arrays of the full-chain round. A copy of the JAX
package's cold build with two pieces left for later slices of the port: the
incremental SnapshotCache path, and the PVC/PV/StorageClass classification
(VolumeZone/VolumeBinding). A state carrying storage objects raises
NotImplementedError; pvc_names without storage objects stay opaque CSI-count
tokens and produce vol_needed, as in the reference.
"""

from __future__ import annotations

import json
import logging
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from koordinator_tpu_torch.api.objects import (
    ANNOTATION_RESOURCE_SPEC,
    ElasticQuota,
    Node,
    NodeMetric,
    NodeResourceTopology,
    Pod,
    PodGroup,
)
from koordinator_tpu_torch.api.qos import QoSClass
from koordinator_tpu_torch.api.resources import (
    NUM_RESOURCES,
    RESOURCE_INDEX,
    ResourceList,
    ResourceName,
)
from koordinator_tpu_torch.models.full_chain import FullChainInputs
from koordinator_tpu_torch.models.scheduler_model import make_inputs
from koordinator_tpu_torch.ops.loadaware import LoadAwareArgs, build_loadaware_node_state
from koordinator_tpu_torch.ops.numa import MAX_NUMA, POLICY_BY_NAME, POLICY_NONE
from koordinator_tpu_torch.ops.packing import (
    NodeBatch,
    PodBatch,
    fill_ids_from_names,
    pack_nodes,
    pack_pods,
)
from koordinator_tpu_torch.ops.taints import (
    admission_mask,
    degraded_node_count,
    group_node_admission,
    selector_pairs_of,
)
from koordinator_tpu_torch.scheduler.metrics import (
    ADMISSION_DEGRADED_NODES,
    ENCODING_OVERFLOW_PODS,
    VOL_GROUP_DEGRADED_NODES,
)
from koordinator_tpu_torch.ops.quota import (
    MAX_QUOTA_DEPTH,
    QuotaTreeArrays,
    build_quota_tree,
    compute_runtime_quotas,
    merge_group_request,
)
from koordinator_tpu_torch.scheduler.cpu_topology import CPUAllocationState, FULL_PCPUS

logger = logging.getLogger(__name__)

# volume-group budget: more distinct attached-set intersections than this
# degrade to the conservative full count (group 0) — the same stance as the
# admission-signature overflow (ops/taints.py)
MAX_VOL_GROUPS = 16

CPU_IDX = RESOURCE_INDEX[ResourceName.CPU]
PODS_IDX = RESOURCE_INDEX[ResourceName.PODS]


def reduce_to_active_axes(fc: FullChainInputs):
    """Slice every resource axis down to the axes that can actually constrain or
    score this batch: axes with a nonzero pod request, score weight, or filter
    threshold (zero axes never constrain — k8s semantics), plus the pods axis.
    Cuts per-iteration memory traffic of the serial loop by ~3x at the 10k x 5k
    config; the parity emulator consumes the same sliced arrays, so semantics are
    unchanged by construction. Returns (sliced_inputs, active_axis_ids).

    The NUMA zone axis is sliced the same way: trailing all-zero zones (the
    MAX_NUMA padding past the cluster's real socket count) can never fit a
    pod with any positive request nor contribute to the cross-zone total, so
    dropping them is exact for every consumer (XLA/Pallas/wave kernels, the
    numpy oracle and the C++ floor all read K from the array shape). A
    2-socket fleet pays for 2 zones instead of 8 — the per-pod NUMA fit and
    waterfall are the serial loop's widest row blocks."""
    base = fc.base
    active = np.zeros(NUM_RESOURCES, bool)
    active[PODS_IDX] = True
    # cpu/memory always stay: the balanced-allocation score reads their
    # EXISTING node usage even when no pending pod requests the axis —
    # slicing one away would silently disable the term in reduced runs
    active[CPU_IDX] = True
    active[RESOURCE_INDEX[ResourceName.MEMORY]] = True
    for arr in (
        np.asarray(base.fit_requests),
        np.asarray(base.estimated),
        np.asarray(fc.requests),
        np.asarray(base.weights)[None, :],
        np.asarray(base.la_filter_thresholds),
        np.asarray(base.la_prod_thresholds),
    ):
        active |= (arr != 0).any(axis=tuple(range(arr.ndim - 1)))
    idx = np.nonzero(active)[0]

    def cut(arr):
        # host-side slice: arrays are still numpy at pack time and device ops
        # here would trigger per-shape XLA compiles before the step even runs
        return np.take(np.asarray(arr), idx, axis=-1)

    r_fields_base = {
        "fit_requests", "estimated", "allocatable", "requested",
        "la_filter_usage", "la_filter_thresholds", "la_prod_thresholds",
        "la_prod_pod_usage", "la_term_nonprod", "la_term_prod", "weights",
    }
    new_base = ScheduleInputsReplace(base, {k: cut(getattr(base, k)) for k in r_fields_base})
    r_fields_fc = {
        "requests", "numa_free", "numa_capacity", "quota_used", "quota_runtime"
    }
    kwargs = {
        k: (cut(v) if k in r_fields_fc else v)
        for k, v in fc._asdict().items()
        if k != "base"
    }
    # zone-axis slice: keep zones up to the highest with any capacity or
    # free anywhere in the fleet (>=1 so shapes stay rank-stable)
    nf = np.asarray(kwargs["numa_free"])
    nc = np.asarray(kwargs["numa_capacity"])
    zone_any = (nf != 0).any(axis=(0, 2)) | (nc != 0).any(axis=(0, 2))
    k_eff = max(1, int(np.nonzero(zone_any)[0].max()) + 1 if zone_any.any() else 1)
    if k_eff < nf.shape[1]:
        kwargs["numa_free"] = nf[:, :k_eff]
        kwargs["numa_capacity"] = nc[:, :k_eff]
    return FullChainInputs(base=new_base, **kwargs), [int(i) for i in idx]


def ScheduleInputsReplace(base, updates):
    d = base._asdict()
    d.update(updates)
    return type(base)(**d)

# re-exported for existing importers; canonical home is topologymanager.py
from koordinator_tpu_torch.scheduler.topologymanager import (  # noqa: E402
    LABEL_NUMA_TOPOLOGY_POLICY,
    resolve_numa_policy,
)


@dataclass
class ClusterState:
    """Everything the snapshot needs from the store + plugin caches."""

    nodes: List[Node]
    pending_pods: List[Pod]
    node_metrics: Dict[str, NodeMetric]
    pods_by_key: Dict[str, Pod]
    assigned: Dict[str, List[Tuple[Pod, float]]] = field(default_factory=dict)
    assigned_requests: Dict[str, np.ndarray] = field(default_factory=dict)
    topologies: Dict[str, NodeResourceTopology] = field(default_factory=dict)
    cpu_states: Dict[str, CPUAllocationState] = field(default_factory=dict)
    numa_allocated: Dict[str, np.ndarray] = field(default_factory=dict)  # [K, R]
    quotas: List[ElasticQuota] = field(default_factory=list)
    pod_groups: List[PodGroup] = field(default_factory=list)
    gang_assumed: Dict[str, int] = field(default_factory=dict)
    # VolumeZone/volume-limit/VolumeBinding inputs: PVCs by "namespace/name"
    # key, PVs by volume name, StorageClasses by name (all optional — empty
    # means no volume constraints)
    pvcs: Dict[str, object] = field(default_factory=dict)
    pvs: Dict[str, object] = field(default_factory=dict)
    storage_classes: Dict[str, object] = field(default_factory=dict)
    cluster_total: Optional[np.ndarray] = None
    now: float = 0.0


def _pod_cpuset_flags(pod: Pod, default_policy: str = FULL_PCPUS) -> Tuple[bool, float, bool]:
    """(needs_bind, cores_needed, full_pcpus) — AllowUseCPUSet + resource-spec
    annotation (nodenumaresource/plugin.go:219-268)."""
    qos = pod.qos_class
    if qos not in (QoSClass.LSE, QoSClass.LSR):
        return False, 0.0, False
    cpu_milli = pod.spec.requests[ResourceName.CPU]
    if cpu_milli <= 0 or cpu_milli % 1000 != 0:
        return False, 0.0, False
    policy = default_policy
    raw = pod.meta.annotations.get(ANNOTATION_RESOURCE_SPEC)
    if raw:
        try:
            spec = json.loads(raw)
            policy = (
                spec.get("requiredCPUBindPolicy")
                or spec.get("preferredCPUBindPolicy")
                or default_policy
            )
        except (ValueError, TypeError):
            pass
    return True, float(cpu_milli // 1000), policy == FULL_PCPUS


def _pod_flag_tuple(pod: Pod) -> tuple:
    """The per-pod flag row (needs_bind, cores, full_pcpus, needs_numa,
    vol_needed, has_aff, has_ports, has_img, has_npref)."""
    spec = pod.spec
    nb, cn, fp = _pod_cpuset_flags(pod)
    return (nb, cn, fp, bool(spec.requests), float(len(set(spec.pvc_names))),
            bool(spec.pod_affinity or spec.pod_anti_affinity
                 or spec.topology_spread or spec.pod_affinity_preferred),
            bool(spec.host_ports), bool(spec.images),
            bool(spec.affinity_preferred))


def build_full_chain_inputs(
    state: ClusterState, args: LoadAwareArgs
) -> Tuple[FullChainInputs, PodBatch, NodeBatch, QuotaTreeArrays, Dict[str, int], int, int]:
    """Returns (inputs, pod_batch, node_batch, quota_tree, gang_index,
    num_gangs, num_groups); every array of ``inputs`` is numpy."""
    if state.pvcs or state.pvs or state.storage_classes:
        raise NotImplementedError(
            "PVC/PV/StorageClass volume classification (VolumeZone, "
            "VolumeBinding) comes with a later slice of the port")
    # ---- gangs indexed first so pods pack in one pass; quota ids are filled
    # into the packed batch after the tree is built (they need the tree)
    gang_index = {pg.meta.key: i for i, pg in enumerate(state.pod_groups)}
    pods = pack_pods(
        state.pending_pods,
        args.resource_weights,
        args.estimated_scaling_factors,
        gang_ids=gang_index,
        gang_sort={
            pg.meta.key: (pg.meta.creation_timestamp, pg.meta.key)
            for pg in state.pod_groups
        },
    )
    # keyed off the packed batch (keys computed once inside pack_pods)
    pods_by_key_pending = dict(zip(pods.keys, pods.objs))

    # ---- quota tree: pending requests accumulate from the PACKED rows (one
    # to_vector per pod already happened inside pack_pods). Grouped by the
    # quota-name column with one segment-sum; np.add.at processes rows in
    # ascending packed order, the same float32 accumulation sequence the
    # per-pod loop produced.
    pod_req_by_quota: Dict[str, np.ndarray] = {}
    n_valid = pods.num_valid
    qn_col = pods.quota_names[:n_valid]
    q_rows = np.nonzero(qn_col != "")[0]
    if q_rows.size:
        q_uniq, q_inv = np.unique(qn_col[q_rows].astype(str),
                                  return_inverse=True)
        q_sums = np.zeros((len(q_uniq), NUM_RESOURCES), np.float32)
        np.add.at(q_sums, q_inv, pods.requests[q_rows])
        pod_req_by_quota = {str(q): q_sums[j] for j, q in enumerate(q_uniq)}
    # assigned quota usage: ONE wire-matrix fill + scale + segment-sum
    # instead of a per-pod to_vector allocation
    used_by_quota: Dict[str, np.ndarray] = {}
    quota_pods: List[Tuple[str, Pod]] = []
    for pod in state.pods_by_key.values():
        q = pod.quota_name
        if q and pod.is_assigned and not pod.is_terminated:
            quota_pods.append((q, pod))
    if quota_pods:
        mat = ResourceList.pack_wire_matrix(
            pod.spec.requests for _q, pod in quota_pods)
        names = sorted({q for q, _p in quota_pods})
        row_of = {q: j for j, q in enumerate(names)}
        sums = np.zeros((len(names), NUM_RESOURCES), np.float32)
        np.add.at(sums, [row_of[q] for q, _p in quota_pods], mat)
        used_by_quota = {q: sums[j] for q, j in row_of.items()}
    # group request counts EVERY member pod — running AND pending; a
    # pending-only request would understate runtime for groups with running
    # usage and deny admission their min already guarantees
    pod_req_by_quota = merge_group_request(pod_req_by_quota, used_by_quota)
    tree = build_quota_tree(state.quotas, pod_req_by_quota, used_by_quota)
    if state.cluster_total is None:
        # one matrix fill + scale + sum (not 5k per-node to_vector calls)
        total = ResourceList.pack_wire_matrix(
            node.allocatable for node in state.nodes).sum(axis=0)
    else:
        total = state.cluster_total
    runtime = (
        compute_runtime_quotas(tree, total)
        if tree.names
        else np.zeros((1, NUM_RESOURCES), np.float32)
    )
    quota_ids = {name: i for i, name in enumerate(tree.names)}

    # ---- gangs
    ng = max(1, len(state.pod_groups))
    gang_min = np.zeros(ng, np.float32)
    gang_assumed = np.zeros(ng, np.float32)
    gang_total = np.zeros(ng, np.float32)
    for pg in state.pod_groups:
        i = gang_index[pg.meta.key]
        gang_min[i] = pg.min_member
        gang_assumed[i] = state.gang_assumed.get(pg.meta.key, 0)
        gang_total[i] = gang_assumed[i]
    # pending members per gang: unique-count over the packed gang column
    # (integer counts — accumulation order free)
    gk_col = pods.gang_keys[:n_valid]
    gk_rows = np.nonzero(gk_col != "")[0]
    if gk_rows.size:
        gk_uniq, gk_counts = np.unique(gk_col[gk_rows].astype(str),
                                       return_counts=True)
        for g, c in zip(gk_uniq, gk_counts):
            gi = gang_index.get(str(g))
            if gi is not None:
                gang_total[gi] += c
    gang_valid = gang_total >= gang_min
    gang_group = np.arange(ng, dtype=np.int32)  # group == gang (annotation later)

    # ---- per-pod flags (single pass over the packed order)
    P = pods.padded_size
    needs_bind = np.zeros(P, bool)
    cores_needed = np.zeros(P, np.float32)
    full_pcpus = np.zeros(P, bool)
    needs_numa = np.zeros(P, bool)
    pod_taint_mask = np.ones(P, np.float32)  # padding admits group 0
    # admission factorization (ops/taints.py): node (taint set, matched
    # selector pairs) signatures -> group ids, pod tolerations +
    # nodeSelector -> group bitmasks. This is how TaintToleration AND
    # NodeAffinity (nodeSelector) batch into one bit test.
    sel_pairs = selector_pairs_of(pods_by_key_pending.values(), {})
    node_taint_ids, admission_groups = group_node_admission(
        state.nodes, sel_pairs)
    ADMISSION_DEGRADED_NODES.set(
        float(degraded_node_count(node_taint_ids, admission_groups)))
    vol_needed = np.zeros(P, np.float32)
    # per-row feature presence (affinity/spread specs, hostPorts, images,
    # preferred node affinity): the candidate-row sets the batch encoders
    # below restrict their extraction loops to
    has_aff = np.zeros(P, bool)
    has_ports = np.zeros(P, bool)
    has_img = np.zeros(P, bool)
    has_npref = np.zeros(P, bool)
    for i in range(n_valid):
        pod = pods_by_key_pending[pods.keys[i]]
        (needs_bind[i], cores_needed[i], full_pcpus[i], needs_numa[i],
         vol_needed[i], has_aff[i], has_ports[i], has_img[i],
         has_npref[i]) = _pod_flag_tuple(pod)
        pod_taint_mask[i] = admission_mask(pod, admission_groups, frozenset())
    # quota ids resolve only after the tree exists — one vectorized
    # unique-name map over the packed quota column
    fill_ids_from_names(pods.quota_id, pods.quota_names[:n_valid], quota_ids)
    # ---- nodes
    nodes = pack_nodes(state.nodes, assigned_requests=state.assigned_requests)
    N = nodes.padded_size
    nodes.extras = build_loadaware_node_state(
        state.nodes,
        state.node_metrics,
        state.pods_by_key,
        state.assigned,
        args,
        state.now,
        pad_to=N,
    )
    node_taint_group = np.zeros(N, np.int32)  # padding: empty set
    node_taint_group[: len(node_taint_ids)] = node_taint_ids
    numa_free = np.zeros((N, MAX_NUMA, NUM_RESOURCES), np.float32)
    numa_capacity = np.zeros((N, MAX_NUMA, NUM_RESOURCES), np.float32)
    numa_policy = np.full(N, POLICY_NONE, np.int32)
    has_topology = np.zeros(N, bool)
    bind_free = np.zeros(N, np.float32)
    cpus_per_core = np.ones(N, np.float32)
    # zone capacities via ONE wire-matrix fill + scale + scatter (not a
    # per-zone to_vector allocation: ~2 zones x every topology node)
    zone_at: List[Tuple[int, int]] = []
    zone_lists: List = []
    topo_nodes: List[int] = []
    for i, node in enumerate(state.nodes):
        topo_cr = state.topologies.get(node.meta.name)
        if topo_cr is not None and topo_cr.cpus:
            topo_nodes.append(i)
            has_topology[i] = True
            numa_policy[i] = POLICY_BY_NAME.get(
                resolve_numa_policy(node.meta.labels,
                                    topo_cr.kubelet_cpu_manager_policy),
                POLICY_NONE)
            for zone in topo_cr.zones:
                if 0 <= zone.numa_id < MAX_NUMA:
                    zone_at.append((i, zone.numa_id))
                    zone_lists.append(zone.allocatable)
    if zone_at:
        zmat = ResourceList.pack_wire_matrix(zone_lists)
        idx = np.asarray(zone_at)
        numa_capacity[idx[:, 0], idx[:, 1]] = zmat
    for i in topo_nodes:
        node = state.nodes[i]
        name = node.meta.name
        alloc = state.numa_allocated.get(name)
        numa_free[i] = numa_capacity[i] - (alloc if alloc is not None else 0.0)
        cpu_state = state.cpu_states.get(name)
        if cpu_state is not None:
            bind_free[i] = cpu_state.num_available()
            cpus_per_core[i] = cpu_state.topology.cpus_per_core
        else:
            bind_free[i] = numa_free[i, :, CPU_IDX].sum() / 1000.0
            cpus_per_core[i] = 2.0
    # no topology: NUMA admission passes only via POLICY_NONE; spread the
    # node allocatable into one virtual zone so zero-topology clusters
    # still quota-fit (vectorized over the non-topology rows)
    no_topo = np.nonzero(~has_topology[: len(state.nodes)])[0]
    if no_topo.size:
        numa_capacity[no_topo, 0] = nodes.allocatable[no_topo]
        numa_free[no_topo, 0] = (nodes.allocatable[no_topo]
                                 - nodes.requested[no_topo])

    # inter-pod (anti-)affinity factorization (ops/podaffinity.py): the
    # batch's distinct terms -> per-node domain/count state + per-pod term
    # rows, in pods.keys order, padded to the bucketed shapes
    from koordinator_tpu_torch.ops.podaffinity import build_affinity_state

    ordered_pending = pods.objs
    existing = [
        p for p in state.pods_by_key.values()
        if p.is_assigned and not p.is_terminated
    ]
    (_aff_terms, term_ids, dom_v, count_v, cover_v, aff_exists, aff_req_v,
     anti_req_v, match_v, spread_v, aff_overflow) = build_affinity_state(
        ordered_pending, state.nodes, existing,
        rows=np.nonzero(has_aff[:n_valid])[0])
    T = dom_v.shape[1]
    aff_dom = np.full((N, T), -1.0, np.float32)
    aff_dom[: dom_v.shape[0]] = dom_v
    aff_count = np.zeros((N, T), np.float32)
    aff_count[: count_v.shape[0]] = count_v
    anti_cover = np.zeros((N, T), np.float32)
    anti_cover[: cover_v.shape[0]] = cover_v
    pod_aff_req = np.zeros((P, T), bool)
    pod_aff_req[: aff_req_v.shape[0]] = aff_req_v
    pod_anti_req = np.zeros((P, T), bool)
    pod_anti_req[: anti_req_v.shape[0]] = anti_req_v
    pod_aff_match = np.zeros((P, T), bool)
    pod_aff_match[: match_v.shape[0]] = match_v
    pod_spread_skew = np.zeros((P, T), np.float32)
    pod_spread_skew[: spread_v.shape[0]] = spread_v
    for i in aff_overflow:  # conservative: term encoding overflow
        pods.valid[i] = False
        pods.unschedulable_reasons[i] = (
            "(anti-)affinity term budget exceeded for this round")
        ENCODING_OVERFLOW_PODS.inc(kind="affinity_terms")

    # preferred node affinity (soft scoring), profile-bucketed
    from koordinator_tpu_torch.ops.podaffinity import (
        build_preferred_pod_profiles,
        build_preferred_scores,
    )

    pref_rows_v, pref_id_v = build_preferred_scores(
        ordered_pending, state.nodes, rows=np.nonzero(has_npref[:n_valid])[0])
    # TRUE zero columns when no pod carries a preference: the kernels gate
    # profile work on the column count, so empty batches pay nothing
    n_pref = pref_rows_v.shape[0] if (pref_id_v >= 0).any() else 0
    pref_scores = np.zeros((N, n_pref), np.float32)
    pref_scores[: pref_rows_v.shape[1], :] = pref_rows_v[:n_pref].T
    pod_pref_id = np.full(P, -1, np.int32)
    pod_pref_id[: pref_id_v.shape[0]] = pref_id_v

    # preferred POD affinity (weighted, over the shared term space)
    ppref_w, ppref_id_v, ppref_mask_v = build_preferred_pod_profiles(
        ordered_pending, term_ids, T, rows=np.nonzero(has_aff[:n_valid])[0])
    pod_ppref_id = np.full(P, -1, np.int32)
    pod_ppref_id[: ppref_id_v.shape[0]] = ppref_id_v
    pod_ppref_mask = np.zeros((P, T), bool)
    pod_ppref_mask[: ppref_mask_v.shape[0]] = ppref_mask_v[:, :T]

    # NodePorts factorization + CSI volume-limit counts + ImageLocality
    # profiles (ops/ports.py)
    from koordinator_tpu_torch.ops.ports import build_image_scores, build_port_state

    _slots, used_v, wants_v, port_overflow = build_port_state(
        ordered_pending, state.nodes, existing,
        rows=np.nonzero(has_ports[:n_valid])[0])
    PT = used_v.shape[1]
    port_used = np.zeros((N, PT), np.float32)
    port_used[: used_v.shape[0]] = used_v
    pod_port_wants = np.zeros((P, PT), bool)
    pod_port_wants[: wants_v.shape[0]] = wants_v
    for i in port_overflow:  # conservative: slot encoding overflow
        pods.valid[i] = False
        pods.unschedulable_reasons[i] = (
            "hostPort slot budget exceeded for this round")
        ENCODING_OVERFLOW_PODS.inc(kind="port_slots")
    vol_free = np.full(N, np.inf, np.float32)
    attached: Dict[str, set] = {}
    for pod in existing:
        if pod.spec.pvc_names:
            attached.setdefault(pod.spec.node_name, set()).update(
                f"{pod.meta.namespace}/{c}" for c in pod.spec.pvc_names)
    for i, node in enumerate(state.nodes):
        if node.attachable_volume_limit > 0:
            vol_free[i] = node.attachable_volume_limit - len(
                attached.get(node.meta.name, ()))
    # volume-group factorization (upstream NodeVolumeLimits' already-
    # attached exemption): nodes whose attached-claim sets intersect the
    # PENDING batch's claims identically share a group, and vol_needed
    # expands to [P, VG] rows counting only NEW attachments per group.
    # Group 0 is the empty intersection (the common case: VG == 1 and the
    # column equals the plain per-pod count). Budget overflow degrades a
    # node to group 0 — the conservative full count, the pre-exemption
    # behavior. Known divergence: TWO PENDING pods sharing a claim in the
    # same batch each count it (the groups are frozen at pack time, while
    # upstream's assume cache sees the first binding); conservative, and
    # self-corrects next cycle when the binding reaches the attached sets.
    node_vol_group = np.zeros(N, np.int32)
    group_sets: List[frozenset] = [frozenset()]
    pending_claims: Dict[str, frozenset] = {}
    for key, pod in pods_by_key_pending.items():
        if pod.spec.pvc_names:
            pending_claims[key] = frozenset(
                f"{pod.meta.namespace}/{c}" for c in pod.spec.pvc_names)
    vol_degraded = 0
    if pending_claims and attached:
        claim_universe = frozenset().union(*pending_claims.values())
        gid_of = {frozenset(): 0}
        for i, node in enumerate(state.nodes):
            s = frozenset(attached.get(node.meta.name, ())) & claim_universe
            gid = gid_of.get(s)
            if gid is None:
                if len(group_sets) >= MAX_VOL_GROUPS:
                    # overflow: the node loses its exemption (full count) —
                    # surfaced like the admission-signature degradation
                    gid = 0
                    vol_degraded += 1
                    logger.debug(
                        "node %s exceeds the volume-group budget (%d)",
                        node.meta.name, MAX_VOL_GROUPS)
                else:
                    gid = gid_of[s] = len(group_sets)
                    group_sets.append(s)
            node_vol_group[i] = gid
    if vol_degraded:
        # one aggregate line per build, not one per node per cycle
        logger.warning(
            "%d nodes exceed the volume-group budget (%d): pods pay the "
            "full attachment count there", vol_degraded, MAX_VOL_GROUPS)
    VOL_GROUP_DEGRADED_NODES.set(float(vol_degraded))
    VG = len(group_sets)
    vol_needed_g = np.zeros((P, VG), np.float32)
    vol_needed_g[:, 0] = vol_needed
    if VG > 1:
        for i, key in enumerate(pods.keys):
            claims = pending_claims.get(key)
            for g in range(1, VG):
                vol_needed_g[i, g] = (len(claims - group_sets[g])
                                      if claims else 0.0)
    img_rows_v, img_id_v = build_image_scores(
        ordered_pending, state.nodes, rows=np.nonzero(has_img[:n_valid])[0])
    n_img = img_rows_v.shape[0] if (img_id_v >= 0).any() else 0
    img_scores = np.zeros((N, n_img), np.float32)
    img_scores[: img_rows_v.shape[1], :] = img_rows_v[:n_img].T
    pod_img_id = np.full(P, -1, np.int32)
    pod_img_id[: img_id_v.shape[0]] = img_id_v

    base = make_inputs(pods, nodes, args)
    G = max(1, len(tree.names))
    fc = FullChainInputs(
        base=base,
        requests=np.asarray(pods.requests),
        gang_id=np.asarray(pods.gang_id),
        quota_id=np.asarray(pods.quota_id),
        needs_numa=np.asarray(needs_numa),
        needs_bind=np.asarray(needs_bind),
        cores_needed=np.asarray(cores_needed),
        full_pcpus=np.asarray(full_pcpus),
        pod_taint_mask=np.asarray(pod_taint_mask),
        pod_aff_req=np.asarray(pod_aff_req),
        pod_anti_req=np.asarray(pod_anti_req),
        pod_aff_match=np.asarray(pod_aff_match),
        pod_spread_skew=np.asarray(pod_spread_skew),
        pod_pref_id=np.asarray(pod_pref_id),
        pref_scores=np.asarray(pref_scores),
        pod_ppref_id=np.asarray(pod_ppref_id),
        pod_ppref_mask=np.asarray(pod_ppref_mask),
        ppref_w=np.asarray(ppref_w),
        pod_port_wants=np.asarray(pod_port_wants),
        vol_needed=np.asarray(vol_needed_g),
        pod_img_id=np.asarray(pod_img_id),
        port_used=np.asarray(port_used),
        vol_free=np.asarray(vol_free),
        node_vol_group=np.asarray(node_vol_group),
        img_scores=np.asarray(img_scores),
        node_taint_group=np.asarray(node_taint_group),
        aff_dom=np.asarray(aff_dom),
        aff_count=np.asarray(aff_count),
        anti_cover=np.asarray(anti_cover),
        aff_exists=np.asarray(aff_exists),
        numa_free=np.asarray(numa_free),
        numa_capacity=np.asarray(numa_capacity),
        numa_policy=np.asarray(numa_policy),
        has_topology=np.asarray(has_topology),
        bind_free=np.asarray(bind_free),
        cpus_per_core=np.asarray(cpus_per_core),
        quota_ancestors=np.asarray(
            tree.ancestors
            if tree.names
            else np.full((1, MAX_QUOTA_DEPTH), -1, np.int32)
        ),
        quota_used=np.asarray(
            tree.used if tree.names else np.zeros((1, NUM_RESOURCES), np.float32)
        ),
        quota_runtime=np.asarray(runtime if tree.names else np.zeros((1, NUM_RESOURCES), np.float32)),
        gang_min_member=np.asarray(gang_min),
        gang_assumed=np.asarray(gang_assumed),
        gang_valid=np.asarray(gang_valid),
        gang_group_id=np.asarray(gang_group),
    )
    return fc, pods, nodes, tree, gang_index, ng, ng
