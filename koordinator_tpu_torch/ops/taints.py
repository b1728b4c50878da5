"""Node-admission (taint/toleration + nodeSelector) factorization, batched.

The kube-scheduler's TaintToleration and NodeAffinity plugins (vendored
defaults in the reference's scheduler binary) reject nodes whose NoSchedule
taints the pod does not tolerate or whose labels don't satisfy the pod's
nodeSelector. Per-(pod, node) set checks don't batch, so the snapshot
factorizes them: nodes with the same ADMISSION SIGNATURE — their taint set
plus their labels projected onto the selector keys the pending batch uses —
share a small group id (real clusters have a handful of signatures), each
node carries its group id [N], and each pod carries a bitmask of admitted
groups [P] (groups whose taints it tolerates AND whose labels satisfy its
nodeSelector). The kernel check collapses to one elementwise bit test:
``(pod_mask >> node_group) & 1``.

Masks are stored as float32 (exact for < 2^24) so the Pallas kernel can do
the bit test with floor/mod arithmetic — Mosaic lowers those everywhere,
unlike shift-by-vector. Group ``MAX_TAINT_GROUPS - 1`` is the overflow
bucket for clusters with more distinct signatures than bits — no pod ever
admits it (conservative: the scheduler refuses placements it cannot prove,
never the reverse)."""

from __future__ import annotations

import logging
from typing import List, Sequence, Tuple

import numpy as np

logger = logging.getLogger(__name__)

MAX_TAINT_GROUPS = 24  # bits must stay exact in float32 (< 2^24)


def tolerates_taints(tolerations: Sequence[Tuple[str, str]],
                     taints: Sequence[Tuple[str, str]]) -> bool:
    """Exact (key, value) toleration, or (key, "") as a key-wildcard —
    the same rule the descheduler's NodeTaints plugin applies."""
    held = set(tolerations)
    return all(
        (key, value) in held or (key, "") in held for key, value in taints
    )


def selector_pairs_of(pods, extra_pairs_by_key=None) -> frozenset:
    """The distinct (key, value) nodeSelector PAIRS the pending batch uses.
    Signatures are built from pair-match booleans, not raw label values, so
    a high-cardinality key (kubernetes.io/hostname) contributes one bit per
    PIN, not one signature per node: 5k hostnames with one pinned pod split
    the cluster into 2 groups (the pinned node, everyone else), where a
    value-projection signature would fragment all 5k nodes.

    extra_pairs_by_key: per-pod-key additional required pairs (e.g. the
    VolumeZone filter's PV topology labels, scheduler/snapshot.py)."""
    pairs = set()
    for pod in pods:
        pairs.update(pod.spec.node_selector.items())
        pairs.update(pod.spec.affinity_required_node_labels.items())
        if extra_pairs_by_key:
            pairs.update(extra_pairs_by_key.get(pod.meta.key, ()))
    return frozenset(pairs)


def required_node_pairs(pod) -> frozenset:
    """All (key, value) node-label requirements of a pod: nodeSelector AND
    requiredDuringScheduling node affinity matchLabels — kube-scheduler ANDs
    the two (NodeAffinity plugin)."""
    return frozenset(pod.spec.node_selector.items()) | frozenset(
        pod.spec.affinity_required_node_labels.items())


_UNKNOWN = object()  # bucket marker: label matches not encoded for this group


def group_node_admission(
    nodes, selector_pairs: frozenset = frozenset()
) -> Tuple[np.ndarray, List[Tuple[frozenset, object]]]:
    """(group_id [len(nodes)] int32, group signatures). A signature is
    (taint set, frozenset of batch selector pairs the node's labels match).
    When the bit budget runs out, a node degrades to its per-taint-set
    LABEL-UNKNOWN bucket — still exact for selector-less pods (their
    admission never depends on labels) and conservative (never admitted)
    for selector pods. Only if even those buckets exhaust the budget does a
    node land in the final overflow group, which admits nobody — the same
    stance the taint-only grouping always had."""
    overflow = MAX_TAINT_GROUPS - 1
    out = np.zeros(len(nodes), np.int32)
    pairs = sorted(selector_pairs)

    # pass 1: per-node exact signature + frequency
    node_sigs: List[Tuple[frozenset, frozenset]] = []
    counts: dict = {}
    first_seen: dict = {}
    taint_sets: List[frozenset] = []
    for i, node in enumerate(nodes):
        labels = node.meta.labels
        taints = frozenset(node.taints)
        matched = frozenset((k, v) for k, v in pairs if labels.get(k) == v)
        sig = (taints, matched)
        node_sigs.append(sig)
        counts[sig] = counts.get(sig, 0) + 1
        if sig not in first_seen:
            first_seen[sig] = i
        if taints not in taint_sets:
            taint_sets.append(taints)

    # pass 2: exact signatures get the budget minus a reserved slot per
    # taint set (so a label-unknown bucket can ALWAYS be interned when an
    # exact signature overflows — without the reservation the unknown
    # buckets themselves would overflow); most-common signatures first
    sigs: List[Tuple[frozenset, object]] = []
    ids: dict = {}
    exact_budget = max(overflow - min(len(taint_sets), overflow), 0)
    for sig in sorted(counts, key=lambda s: (-counts[s], first_seen[s])):
        if len(ids) >= exact_budget:
            break
        ids[sig] = len(sigs)
        sigs.append(sig)

    degraded: List[str] = []
    for i, node in enumerate(nodes):
        sig = node_sigs[i]
        gid = ids.get(sig)
        if gid is None:  # degrade: label-unknown bucket for this taint set
            key = (sig[0], _UNKNOWN)
            gid = ids.get(key)
            if gid is not None or len(sigs) < overflow:
                if gid is None:
                    gid = ids[key] = len(sigs)
                    sigs.append(key)
                degraded.append(node.meta.name)
            if gid is None:
                gid = overflow
                logger.warning(
                    "admission-signature bit budget exceeded: node %s "
                    "(taints %s) falls into the overflow group and NO pod "
                    "will schedule there (max %d distinct signatures)",
                    node.meta.name, sorted(sig[0]), overflow,
                )
        out[i] = gid
    if degraded:
        # loud by design: selector-carrying pods can NEVER schedule onto a
        # label-unknown bucket, and host-side dry-runs (preemption) must
        # consult this grouping or they will evict victims in vain
        logger.warning(
            "admission-signature budget exceeded: %d nodes degraded to "
            "their label-unknown bucket (selector-carrying pods will not "
            "schedule there this round): %s%s",
            len(degraded), ", ".join(degraded[:5]),
            "..." if len(degraded) > 5 else "",
        )
    return out, sigs


def degraded_node_count(group_ids, groups) -> int:
    """Nodes whose admission signature was NOT exactly encoded: in a
    label-unknown bucket (selector pods can't schedule there) or the
    admit-nobody overflow group. Feeds the scheduler's degradation gauge."""
    return sum(
        1 for g in group_ids
        if g >= len(groups) or groups[g][1] is _UNKNOWN
    )


def admission_mask(pod, groups: List[Tuple[frozenset, object]],
                   extra_pairs: frozenset = frozenset(),
                   any_of_sets: Sequence = ()) -> float:
    """Bitmask (as an exact float32 integer) of the node groups this pod may
    land on: taints tolerated AND every nodeSelector pair in the group's
    matched set. Label-unknown buckets admit only unconstrained pods; the
    overflow group's bit is never set. extra_pairs joins the pod's own
    required set (VolumeZone).

    any_of_sets carries OR-of-AND requirements (the VolumeBinding analog,
    scheduler/volumebinding.py): each element is a collection of
    ALTERNATIVES for one unbound claim — the group must fully match at
    least one alternative's pair set per element (some candidate PV's
    topology, or some provisioner-allowed topology term). An element with
    no satisfiable alternative zeroes the mask: the claim fits nowhere."""
    mask = 0
    tolerations = pod.spec.tolerations
    selector = required_node_pairs(pod) | extra_pairs
    for gid, (taints, matched) in enumerate(groups):
        if taints and not tolerates_taints(tolerations, taints):
            continue
        if matched is _UNKNOWN:
            if selector or any_of_sets:
                continue
        else:
            if not selector <= matched:
                continue
            if any(not any(alt <= matched for alt in alts)
                   for alts in any_of_sets):
                continue
        mask |= 1 << gid
    return float(mask)
